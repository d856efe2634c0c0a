// K3's backward on Hopper: the gradients of blockwise attention with
// respect to q, k and v, recomputing the probabilities from the forward's
// log-sum-exp.
//
// The TPU side has no Pallas kernel for this: the JAX model path
// differentiates its attention with the custom_vjp _flash_core_bwd
// (src/repro/models/layers.py:163-207), a recompute-based blockwise
// backward in XLA.  This file computes what that function computes, per
// (batch, head) and under the forward's causal, sliding-window and
// key-length masks:
//   delta = rowsum(dO * O)
//   p     = exp(s - lse), s = q k^T * scale, masked scores -1e30
//   dv    = p^T dO,  dp = dO v^T,  ds = p (dp - delta) * scale
//   dq    = ds k,    dk = ds^T q
// with p recomputed in f32 (the forward's bf16 p is a forward-only choice
// of the model path), every product accumulated in f32 and the results
// stored in the inputs' type.  Grouped-query attention sums dk and dv over
// the G query heads of a key/value head.
//
// Queries and keys have lengths of their own, Sq and Sk, and query row i
// sits at position q_start + i for the masks, as in the forward
// (flash_attn.cu).  q and k have one width (HDQK) and v and dO another
// (HDV), as in the forward: s, dq and dk run over HDQK, dp, dv and
// delta = rowsum(dO O) over HDV.  The pairs built are the forward's: (d, d)
// for d in 16, 32, 64, 128, 160 and 256, and (192, 128) (MLA).
//
// Three kinds of launch on one stream (several of a kind at the wider
// pairs; flash_bwd_launch lists them):
//   1. delta, one warp per (position, head) row;
//   2. dk and dv, one block per (key/value head, 64-row k-tile, batch row):
//      the k- and v-tiles stay in shared memory while the block walks the
//      live q-tiles of each of the G query heads, and dk, dv accumulate in
//      registers;
//   3. dq, one block per (head, 64-row q-tile, batch row): the q- and
//      dO-tiles stay while the block walks the live k-tiles.
// Each output element is written by exactly one block, in a fixed order,
// so no atomics: the gradients are the same bits from run to run, and a
// resumed training run can be held bit-equal to an unbroken one.  A
// (q-tile, k-tile) pair is visited when the forward's tile test
// (kernel.py::live_block) passes, in both launches; the live tiles of a
// row or column are one run, since each condition is monotone.  Rows past
// Sq and keys past Sk load as zeros and are not stored.
//
// Two kernel pairs, one per input type, as in the forward:
//
// * bf16 (flash_bwd_dkdv_mma_kernel, flash_bwd_dq_mma_kernel), the
//   training path, runs every product on the tensor cores: mma.sync
//   m16n8k16 bf16 with f32 accumulators in registers, tiles bf16 in shared
//   memory (rows padded by 16 bytes) loaded by cp.async and read by
//   ldmatrix (the helpers of mma_bf16.cuh, shared with the forward).
//   Blocks of 4 warps.
//   - dk/dv: each warp owns 16 key rows and computes the tiles transposed,
//     keys as rows: s^T = k q^T and dp^T = v dO^T, k's and v's A fragments
//     by ldmatrix, q's and dO's B fragments by ldmatrix.  The accumulator
//     fragments of p^T and ds^T are, packed, the A fragments of
//     dv += p^T dO and dk += ds^T q, whose B fragments come from the q and
//     dO tiles by ldmatrix.trans; lse and delta are indexed by column.  The
//     q-tile goes in passes of 32 queries (16 at hd 128), so s^T and dp^T
//     hold 16 (8) registers each beside dk and dv (HD / 2 each), and q,
//     dO, lse and delta arrive in a ring of two stages, the next (head,
//     q-tile) loading while the current one is multiplied.
//   - dq: the forward's shape.  Each warp owns 16 query rows: s = q k^T and
//     dp = dO v^T, ds kept in registers as the A fragment of dq += ds k,
//     k's B fragments by ldmatrix.trans; k and v in a ring of two stages.
//   Precision: q, k, v and dO are exact in bf16, so s and dp take one bf16
//   mma per k-step and differ from f32 products only in the order of the
//   sum.  p and ds are not: rounding either to one bf16 before dv, dk and
//   dq exceeds _flash_core_bwd's tolerance several times over.  So each is
//   split, hi = bf16(x) and lo = bf16(x - hi), and each of those three
//   products is two mmas, hi b + lo b, into one f32 accumulator: within
//   about 2^-17 of the f32 product.  p = exp(s - lse) is computed in f32
//   with expf; the scale, the masks and the -1e30 sentinel act on the f32
//   fragments, an element's row and key following the fragment layout.
//   Shared memory at hd 128: 104 KB (dq), 105 KB (dk/dv), two blocks an SM.
//   At hd 160 dk and dv alone would take 160 accumulator registers a
//   thread, beside s^T and dp^T, so they take launches of their own from
//   one kernel template: the dv launch computes s^T and dv += p^T dO (it
//   needs no v-tile and no dp^T), the dk launch s^T, dp^T and
//   dk += ds^T q, each with 80 accumulator registers and queries in passes
//   of 32; the dq launch takes its 64 keys in two passes of 32, so s and
//   dp hold 16 registers each beside dq's 80.  Each output element is
//   still written by one block.  Shared memory at hd 160: 129 KB (dq),
//   130 KB (dk, dv), one block an SM.  At q/k 192 with v 128 the dv launch
//   holds 64 accumulator registers (queries in passes of 32) and the dk
//   launch 96 (passes of 16), and dq's 96 take the keys in passes of 16;
//   shared memory 126-127 KB.  At hd 256 one gradient's accumulators
//   alone would be 128 registers a thread, so every gradient is also cut
//   by columns (Plan: CW): dv, dk and dq each take two launches of 128
//   columns from col0 0 and 128, each recomputing s^T (and dp^T) over all
//   256; shared memory 198-199 KB, one block an SM.  A bf16 backward call is
//   four launches at hd 160 and at (192, 128) and seven at hd 256.
// * f32 (flash_bwd_dkdv_kernel, flash_bwd_dq_kernel) is the correctness
//   path: the CUDA-core kernels of the first version.  Tiles widened to f32
//   in shared memory (rows padded by one float), each of 256 threads owning
//   a 4 x 4 patch of the 64 x 64 score tile and a 4 x hd/16 patch of its
//   output tile.  Shared memory is 194 KB at hd 160 and at (192, 128),
//   one block an SM.  At hd 256 the four tiles would take 263 KB, past a
//   block's 227 KB, so the _x kernels hold three (214 KB), one taking q
//   and dO, or k and v, in turn, and dv and dk take launches of their own
//   (four launches a call).
//
// What bounds it.  Per live (query, key) pair the function needs
// 6 hd_qk + 4 hd_v FLOP (s, dk, dq over hd_qk, dp, dv over hd_v: 2 each;
// 10 hd at equal widths) against reading q, k, v, O, dO once
// and writing dq, dk, dv: operations bind, at 989 TFLOP/s of bf16 on the
// tensor cores.  The bf16 kernels issue 20 hd a pair: the split doubles
// dv, dk and dq (16 hd) and the dq launch recomputes s and dp (4 hd).
// mma.sync reaches a part of the tensor cores' rate, and each warp reads
// its B fragments from shared memory itself, about one ldmatrix.x4 per two
// to three mmas, so shared-memory bandwidth binds beside the tensor cores.
// mma.sync, not wgmma, for the forward's reason (flash_attn.cu): wgmma's
// shared-memory descriptors must match the swizzle the tiles were written
// in, and a mismatch gives wrong numbers, not a fault; the mma.sync
// fragment layouts are the ones the forward has already made right.  The
// f32 kernels run at 67 TFLOP/s of f32 at best and issue 14 hd a pair.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;       // q-tile rows
constexpr int BK = 64;       // k-tile rows
constexpr int THREADS = 256;
constexpr int PS = BK + 1;   // row stride of the p / ds tiles (floats)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

__device__ __forceinline__ bool tile_live(int k0, int q0, int k_len,
                                          int causal, int window) {
  bool live = k0 < k_len;
  if (causal) live = live && k0 <= q0 + BQ - 1;
  if (window > 0) live = live && k0 + BK - 1 > q0 - window;
  return live;
}

__device__ __forceinline__ bool key_live(int qpos, int kpos, int k_len,
                                         int causal, int window) {
  bool ok = kpos < k_len;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// ---------------------------------------------------------------------------
// f32: the CUDA-core kernels (correctness path), and the delta launch both
// types share
// ---------------------------------------------------------------------------
// 64 rows of one head, rows row0 .. row0 + 63 of a (S, heads, W) slab
// with row_stride elements between rows, as f32 into dst[64][W + 1];
// rows past S are zeros.
template <typename T, int W>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          size_t row_stride, int row0,
                                          int S) {
  constexpr int RS = W + 1;
  for (int e = threadIdx.x; e < 64 * W; e += THREADS) {
    const int row = e / W, d = e % W;
    const int pos = row0 + row;
    dst[row * RS + d] =
        pos < S ? to_f32(src[(size_t)pos * row_stride + d]) : 0.f;
  }
}

// out[a][c] = sum_d A[4 ty + a][d] B[tx + 16 c][d] over one 64 x 64 tile
// pair (rows of A and B W + 1 floats apart).
template <int W>
__device__ __forceinline__ void tile_dots(float (&out)[4][4], const float* A,
                                          const float* B, int ty, int tx) {
  constexpr int RS = W + 1;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) out[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < W; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) av[a] = A[(4 * ty + a) * RS + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = B[(tx + 16 * c) * RS + d];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) out[a][c] = fmaf(av[a], bv[c], out[a][c]);
  }
}

// p of row i of the q-tile at row q0 (position q_start + q0 + i) and the
// key at kpos, from their dot q . k: exactly _flash_core_bwd's arithmetic,
// s = dot * scale, masked to -1e30, p = exp(s - lse); rows at or past Sq
// get p = 0.
__device__ __forceinline__ float recompute_p(float dot, int i, int q0,
                                             int q_start, int kpos, int Sq,
                                             int k_len, int causal,
                                             int window, float scale,
                                             const float* lse_s) {
  const float s = key_live(q_start + q0 + i, kpos, k_len, causal, window)
                      ? dot * scale : NEG_INF;
  return q0 + i < Sq ? expf(s - lse_s[i]) : 0.f;
}

// p and ds of the thread's patch of one (q-tile, k-tile) pair, from the
// q/dO tiles (Qs, Ds), the k/v tiles (Ks, Vs) and the rows' lse and delta:
// ds = p (dp - delta) * scale.
template <int HDQK, int HDV>
__device__ __forceinline__ void p_and_ds(float (&p)[4][4], float (&ds)[4][4],
                                         const float* Qs, const float* Ds,
                                         const float* Ks, const float* Vs,
                                         const float* lse_s,
                                         const float* del_s, int q0,
                                         int q_start, int k0, int Sq,
                                         int k_len, int causal, int window,
                                         float scale, int ty, int tx) {
  float dp[4][4];
  tile_dots<HDQK>(p, Qs, Ks, ty, tx);
  tile_dots<HDV>(dp, Ds, Vs, ty, tx);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = 4 * ty + a;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float pr = recompute_p(p[a][c], i, q0, q_start, k0 + tx + 16 * c,
                                   Sq, k_len, causal, window, scale, lse_s);
      p[a][c] = pr;
      ds[a][c] = pr * (dp[a][c] - del_s[i]) * scale;
    }
  }
}

template <int HDQK, int HDV>
constexpr size_t smem_floats() {   // four 64-row tiles, p, ds, lse, delta
  return 2 * (size_t)64 * (HDQK + 1) + 2 * (size_t)64 * (HDV + 1) +
         2 * (size_t)BQ * PS + 2 * BQ;
}

// Whether the four tiles exceed a block's 227 KB of shared memory (hd 256:
// 263 KB), so the f32 launches hold three tiles, one of them taking q and
// dO (or k and v) in turn (the _x kernels below).
template <int HDQK, int HDV>
struct XBuf {
  static constexpr bool value = smem_floats<HDQK, HDV>() * 4 > 232448;
};

// ---------------------------------------------------------------------------
// 1. delta = rowsum(dO * O), one warp per (position, head) row of HDV
// ---------------------------------------------------------------------------
template <typename T, int HDV>
__global__ void __launch_bounds__(THREADS) flash_bwd_delta_kernel(
    const T* __restrict__ o, const T* __restrict__ dout,
    float* __restrict__ delta, size_t rows) {
  const size_t row = ((size_t)blockIdx.x * THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* orow = o + row * HDV;
  const T* drow = dout + row * HDV;
  float acc = 0.f;
  for (int d = lane; d < HDV; d += 32)
    acc = fmaf(to_f32(drow[d]), to_f32(orow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ---------------------------------------------------------------------------
// 2. dk, dv of one k-tile of one key/value head
// ---------------------------------------------------------------------------
template <typename T, int HDQK, int HDV>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int Sq, int Sk, int q_start, int H, int Kh, int k_len, int causal,
    int window, float scale) {
  constexpr int RQ = HDQK + 1, RV = HDV + 1;
  constexpr int NCK = HDQK / 16;       // dk columns per thread
  constexpr int NCV = HDV / 16;        // dv columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;                    // [BK][RQ]
  float* Vs = Ks + BK * RQ;            // [BK][RV]
  float* Qs = Vs + BK * RV;            // [BQ][RQ]
  float* Ds = Qs + BQ * RQ;            // [BQ][RV] dO
  float* Ps = Ds + BQ * RV;            // [BQ][PS] p
  float* Ss = Ps + BQ * PS;            // [BQ][PS] ds
  float* lse_s = Ss + BQ * PS;         // [BQ]
  float* del_s = lse_s + BQ;           // [BQ]

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  // k-tile 0 first: under a causal mask it has the most live q-tiles
  const int kh = blockIdx.x, k0 = blockIdx.y * BK, b = blockIdx.z;
  const int G = H / Kh;
  const size_t q_stride = (size_t)H * HDQK, o_stride = (size_t)H * HDV;
  const size_t k_stride = (size_t)Kh * HDQK, v_stride = (size_t)Kh * HDV;
  const size_t k_base = (size_t)b * Sk * k_stride + (size_t)kh * HDQK;
  const size_t v_base = (size_t)b * Sk * v_stride + (size_t)kh * HDV;
  load_rows<T, HDQK>(Ks, k + k_base, k_stride, k0, Sk);
  load_rows<T, HDV>(Vs, v + v_base, v_stride, k0, Sk);

  float dka[4][NCK], dva[4][NCV];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int c = 0; c < NCK; ++c) dka[a][c] = 0.f;
#pragma unroll
    for (int c = 0; c < NCV; ++c) dva[a][c] = 0.f;
  }

  const int n_q = (Sq + BQ - 1) / BQ;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const size_t q_base = (size_t)b * Sq * q_stride + (size_t)h * HDQK;
    const size_t o_base = (size_t)b * Sq * o_stride + (size_t)h * HDV;
    for (int qt = 0; qt < n_q; ++qt) {
      const int q0 = qt * BQ;
      if (!tile_live(k0, q_start + q0, k_len, causal, window))
        continue;                      // block-uniform
      __syncthreads();                 // the last pair's readers are done
      load_rows<T, HDQK>(Qs, q + q_base, q_stride, q0, Sq);
      load_rows<T, HDV>(Ds, dout + o_base, o_stride, q0, Sq);
      if (tid < BQ) {
        const int pos = q0 + tid;
        const size_t row = ((size_t)b * Sq + pos) * H + h;
        lse_s[tid] = pos < Sq ? lse[row] : 0.f;
        del_s[tid] = pos < Sq ? delta[row] : 0.f;
      }
      __syncthreads();
      float p[4][4], ds[4][4];
      p_and_ds<HDQK, HDV>(p, ds, Qs, Ds, Ks, Vs, lse_s, del_s, q0, q_start,
                          k0, Sq, k_len, causal, window, scale, ty, tx);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          Ps[(4 * ty + a) * PS + tx + 16 * c] = p[a][c];
          Ss[(4 * ty + a) * PS + tx + 16 * c] = ds[a][c];
        }
      __syncthreads();
      // dv[j][n] += sum_i p[i][j] dO[i][n];  dk[j][n] += sum_i ds[i][j] q[i][n]
      for (int i = 0; i < BQ; ++i) {
        float pj[4], sj[4], dov[NCV], qv[NCK];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pj[a] = Ps[i * PS + 4 * ty + a];
          sj[a] = Ss[i * PS + 4 * ty + a];
        }
#pragma unroll
        for (int c = 0; c < NCV; ++c) dov[c] = Ds[i * RV + tx + 16 * c];
#pragma unroll
        for (int c = 0; c < NCK; ++c) qv[c] = Qs[i * RQ + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
#pragma unroll
          for (int c = 0; c < NCV; ++c)
            dva[a][c] = fmaf(pj[a], dov[c], dva[a][c]);
#pragma unroll
          for (int c = 0; c < NCK; ++c)
            dka[a][c] = fmaf(sj[a], qv[c], dka[a][c]);
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int pos = k0 + 4 * ty + a;
    if (pos >= Sk) continue;
    T* dkr = dk + k_base + (size_t)pos * k_stride;
    T* dvr = dv + v_base + (size_t)pos * v_stride;
#pragma unroll
    for (int c = 0; c < NCK; ++c) dkr[tx + 16 * c] = from_f32<T>(dka[a][c]);
#pragma unroll
    for (int c = 0; c < NCV; ++c) dvr[tx + 16 * c] = from_f32<T>(dva[a][c]);
  }
}

// ---------------------------------------------------------------------------
// 3. dq of one q-tile of one head
// ---------------------------------------------------------------------------
template <typename T, int HDQK, int HDV>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Sk,
    int q_start, int H, int Kh, int k_len, int causal, int window,
    float scale) {
  constexpr int RQ = HDQK + 1, RV = HDV + 1;
  constexpr int NC = HDQK / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * RQ;
  float* Qs = Vs + BK * RV;
  float* Ds = Qs + BQ * RQ;
  float* Ss = Ds + BQ * RV + BQ * PS;  // ds (the p tile is not needed)
  float* lse_s = Ss + BQ * PS;
  float* del_s = lse_s + BQ;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  // the last q-tile first: under a causal mask it has the most live k-tiles
  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = blockIdx.z;
  const int kh = h / (H / Kh);
  const size_t q_stride = (size_t)H * HDQK, o_stride = (size_t)H * HDV;
  const size_t k_stride = (size_t)Kh * HDQK, v_stride = (size_t)Kh * HDV;
  const size_t q_base = (size_t)b * Sq * q_stride + (size_t)h * HDQK;
  const size_t o_base = (size_t)b * Sq * o_stride + (size_t)h * HDV;
  const size_t k_base = (size_t)b * Sk * k_stride + (size_t)kh * HDQK;
  const size_t v_base = (size_t)b * Sk * v_stride + (size_t)kh * HDV;
  load_rows<T, HDQK>(Qs, q + q_base, q_stride, q0, Sq);
  load_rows<T, HDV>(Ds, dout + o_base, o_stride, q0, Sq);
  if (tid < BQ) {
    const int pos = q0 + tid;
    const size_t row = ((size_t)b * Sq + pos) * H + h;
    lse_s[tid] = pos < Sq ? lse[row] : 0.f;
    del_s[tid] = pos < Sq ? delta[row] : 0.f;
  }

  float dqa[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) dqa[a][c] = 0.f;

  const int n_k = (Sk + BK - 1) / BK;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    if (!tile_live(k0, q_start + q0, k_len, causal, window))
      continue;                        // block-uniform
    __syncthreads();                   // the last tile's readers are done
    load_rows<T, HDQK>(Ks, k + k_base, k_stride, k0, Sk);
    load_rows<T, HDV>(Vs, v + v_base, v_stride, k0, Sk);
    __syncthreads();
    float p[4][4], ds[4][4];
    p_and_ds<HDQK, HDV>(p, ds, Qs, Ds, Ks, Vs, lse_s, del_s, q0, q_start, k0,
                        Sq, k_len, causal, window, scale, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        Ss[(4 * ty + a) * PS + tx + 16 * c] = ds[a][c];
    __syncthreads();
    // dq[i][n] += sum_j ds[i][j] k[j][n]
    for (int j = 0; j < BK; ++j) {
      float sv[4], kv[NC];
#pragma unroll
      for (int a = 0; a < 4; ++a) sv[a] = Ss[(4 * ty + a) * PS + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = Ks[j * RQ + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < NC; ++c) dqa[a][c] = fmaf(sv[a], kv[c], dqa[a][c]);
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int pos = q0 + 4 * ty + a;
    if (pos >= Sq) continue;
    T* dqr = dq + q_base + (size_t)pos * q_stride;
#pragma unroll
    for (int c = 0; c < NC; ++c) dqr[tx + 16 * c] = from_f32<T>(dqa[a][c]);
  }
}

// What a launch of a dk/dv kernel computes: both (bf16 at equal widths up
// to 128), or dv alone and dk alone, in launches of their own.
enum Part { DKDV = 0, DV = 1, DK = 2 };

// ---------------------------------------------------------------------------
// 2x, 3x. f32 at hd 256 (XBuf): the same arithmetic as kernels 2 and 3 in
// the same order, with three tiles in shared memory.  dv and dk take
// launches of their own (PART): the dv launch holds k and one tile that
// takes q (for p), then dO (for dv += p^T dO); the dk launch holds k, v and
// one tile that takes dO (for dp), then q (for p, ds and dk += ds^T q).
// The dq launch holds q and dO and one tile that takes v (for dp), then k
// (for p, ds and dq += ds k).  214 KB at hd 256, one block an SM.
// ---------------------------------------------------------------------------
template <int HD, int PART>
constexpr size_t dkdv_x_smem_floats() {
  return (size_t)(PART == DK ? 3 : 2) * 64 * (HD + 1) + (size_t)BQ * PS +
         2 * BQ;
}

template <int HD>
constexpr size_t dq_x_smem_floats() {
  return (size_t)3 * 64 * (HD + 1) + (size_t)BQ * PS + 2 * BQ;
}

template <typename T, int HD, int PART>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv_x_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int Sq, int Sk, int q_start, int H, int Kh, int k_len, int causal,
    int window, float scale) {
  static_assert(PART == DV || PART == DK, "one gradient a launch");
  constexpr bool GK = PART == DK;
  constexpr int RS = HD + 1;
  constexpr int NC = HD / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                    // [BK][RS]
  float* Xs = Ks + BK * RS;            // [BQ][RS] q or dO
  float* Ws = Xs + BQ * RS;            // [BQ][PS] p (dv) or ds (dk)
  float* lse_s = Ws + BQ * PS;         // [BQ]
  float* del_s = lse_s + BQ;           // [BQ]
  float* Vs = del_s + BQ;              // [BK][RS], the dk launch's

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int kh = blockIdx.x, k0 = blockIdx.y * BK, b = blockIdx.z;
  const int G = H / Kh;
  const size_t q_stride = (size_t)H * HD;
  const size_t kv_stride = (size_t)Kh * HD;
  const size_t kv_base = (size_t)b * Sk * kv_stride + (size_t)kh * HD;
  load_rows<T, HD>(Ks, k + kv_base, kv_stride, k0, Sk);
  if constexpr (GK) load_rows<T, HD>(Vs, v + kv_base, kv_stride, k0, Sk);

  float acc[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = 0.f;

  const int n_q = (Sq + BQ - 1) / BQ;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const size_t q_base = (size_t)b * Sq * q_stride + (size_t)h * HD;
    for (int qt = 0; qt < n_q; ++qt) {
      const int q0 = qt * BQ;
      if (!tile_live(k0, q_start + q0, k_len, causal, window))
        continue;                      // block-uniform
      __syncthreads();                 // the last pair's readers are done
      load_rows<T, HD>(Xs, (GK ? dout : q) + q_base, q_stride, q0, Sq);
      if (tid < BQ) {
        const int pos = q0 + tid;
        const size_t row = ((size_t)b * Sq + pos) * H + h;
        lse_s[tid] = pos < Sq ? lse[row] : 0.f;
        del_s[tid] = pos < Sq ? delta[row] : 0.f;
      }
      __syncthreads();
      float dp[4][4];
      if constexpr (GK) {
        tile_dots<HD>(dp, Xs, Vs, ty, tx);
        __syncthreads();
        load_rows<T, HD>(Xs, q + q_base, q_stride, q0, Sq);
        __syncthreads();
      }
      float s[4][4];
      tile_dots<HD>(s, Xs, Ks, ty, tx);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = 4 * ty + a;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float pr = recompute_p(s[a][c], i, q0, q_start,
                                       k0 + tx + 16 * c, Sq, k_len, causal,
                                       window, scale, lse_s);
          float w = pr;
          if constexpr (GK) w = pr * (dp[a][c] - del_s[i]) * scale;
          Ws[i * PS + tx + 16 * c] = w;
        }
      }
      __syncthreads();
      if constexpr (!GK) {
        load_rows<T, HD>(Xs, dout + q_base, q_stride, q0, Sq);
        __syncthreads();
      }
      // acc[j][n] += sum_i w[i][j] x[i][n]: dv (w = p, x = dO) or dk
      // (w = ds, x = q)
      for (int i = 0; i < BQ; ++i) {
        float wj[4], xv[NC];
#pragma unroll
        for (int a = 0; a < 4; ++a) wj[a] = Ws[i * PS + 4 * ty + a];
#pragma unroll
        for (int c = 0; c < NC; ++c) xv[c] = Xs[i * RS + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[a][c] = fmaf(wj[a], xv[c], acc[a][c]);
      }
    }
  }
  T* out = GK ? dk : dv;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int pos = k0 + 4 * ty + a;
    if (pos >= Sk) continue;
    T* row = out + kv_base + (size_t)pos * kv_stride;
#pragma unroll
    for (int c = 0; c < NC; ++c) row[tx + 16 * c] = from_f32<T>(acc[a][c]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_x_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Sk,
    int q_start, int H, int Kh, int k_len, int causal, int window,
    float scale) {
  constexpr int RS = HD + 1;
  constexpr int NC = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                    // [BQ][RS]
  float* Ds = Qs + BQ * RS;            // [BQ][RS] dO
  float* Xs = Ds + BQ * RS;            // [BK][RS] v or k
  float* Ss = Xs + BK * RS;            // [BQ][PS] ds
  float* lse_s = Ss + BQ * PS;
  float* del_s = lse_s + BQ;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = blockIdx.z;
  const int kh = h / (H / Kh);
  const size_t q_stride = (size_t)H * HD;
  const size_t kv_stride = (size_t)Kh * HD;
  const size_t q_base = (size_t)b * Sq * q_stride + (size_t)h * HD;
  const size_t kv_base = (size_t)b * Sk * kv_stride + (size_t)kh * HD;
  load_rows<T, HD>(Qs, q + q_base, q_stride, q0, Sq);
  load_rows<T, HD>(Ds, dout + q_base, q_stride, q0, Sq);
  if (tid < BQ) {
    const int pos = q0 + tid;
    const size_t row = ((size_t)b * Sq + pos) * H + h;
    lse_s[tid] = pos < Sq ? lse[row] : 0.f;
    del_s[tid] = pos < Sq ? delta[row] : 0.f;
  }

  float dqa[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) dqa[a][c] = 0.f;

  const int n_k = (Sk + BK - 1) / BK;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    if (!tile_live(k0, q_start + q0, k_len, causal, window))
      continue;                        // block-uniform
    __syncthreads();                   // the last tile's readers are done
    load_rows<T, HD>(Xs, v + kv_base, kv_stride, k0, Sk);
    __syncthreads();
    float dp[4][4], s[4][4];
    tile_dots<HD>(dp, Ds, Xs, ty, tx);
    __syncthreads();
    load_rows<T, HD>(Xs, k + kv_base, kv_stride, k0, Sk);
    __syncthreads();
    tile_dots<HD>(s, Qs, Xs, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = 4 * ty + a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float pr = recompute_p(s[a][c], i, q0, q_start,
                                     k0 + tx + 16 * c, Sq, k_len, causal,
                                     window, scale, lse_s);
        Ss[i * PS + tx + 16 * c] = pr * (dp[a][c] - del_s[i]) * scale;
      }
    }
    __syncthreads();
    for (int j = 0; j < BK; ++j) {
      float sv[4], kv[NC];
#pragma unroll
      for (int a = 0; a < 4; ++a) sv[a] = Ss[(4 * ty + a) * PS + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = Xs[j * RS + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < NC; ++c) dqa[a][c] = fmaf(sv[a], kv[c], dqa[a][c]);
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int pos = q0 + 4 * ty + a;
    if (pos >= Sq) continue;
    T* dqr = dq + q_base + (size_t)pos * q_stride;
#pragma unroll
    for (int c = 0; c < NC; ++c) dqr[tx + 16 * c] = from_f32<T>(dqa[a][c]);
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels (training path)
// ---------------------------------------------------------------------------
constexpr int MMA_WARPS = 4;           // 16 key (dk/dv) or query (dq) rows each
constexpr int MMA_THREADS = 32 * MMA_WARPS;
// How the bf16 launches cut the work at a width pair: dk and dv in one
// launch up to hd 128 at equal widths, else in launches of their own; and
// the columns of dk, dv and dq a launch accumulates (CW): all of them up
// to 192, halves at 256 (two launches each, col0 0 and 128), so that no
// launch holds more than 96 accumulator registers a thread for one
// gradient (dk alone at 256 would hold 128).
template <int HDQK, int HDV>
struct Plan {
  static constexpr bool split = HDQK != HDV || HDQK > 128;
  static constexpr int cw_k = HDQK > 192 ? HDQK / 2 : HDQK;
  static constexpr int cw_v = HDV > 192 ? HDV / 2 : HDV;
};
// Queries per pass of the dk/dv kernel, by the accumulator registers a
// launch holds (CW / 2 for each of dk and dv it computes): at hd 128 both
// (128) in passes of 32 spill (255 registers and 72 bytes), passes of 16
// fit in 248; 80 (hd 160, dk or dv alone) and fewer take passes of 32.
template <int CW, int PART>
struct Qsub {
  static constexpr int acc = (PART == DKDV ? 2 : 1) * CW / 2;
  static constexpr int value = acc > 80 ? 16 : 32;
};
// Keys per pass of the dq kernel: s and dp cover 64 keys beside up to 64
// accumulator registers, 32 beside 80 (hd 160), 16 beside 96 (dq at 192).
template <int CW>
struct Ksub {
  static constexpr int value = CW / 2 <= 64 ? 64 : CW / 2 <= 80 ? 32 : 16;
};
static_assert(BQ == 16 * MMA_WARPS && BQ == BK && BK == TILE_ROWS,
              "mma tiling");
static_assert(MMA_THREADS == 2 * BQ, "one lse or delta load a thread");

template <int HDQK, int HDV>
constexpr size_t dkdv_mma_smem_bytes() {  // k, v; 2 stages of q, dO; lse, delta
  return (size_t)(BK + 2 * BQ) * (HDQK + SPAD) * sizeof(bf16) +
         (size_t)(BK + 2 * BQ) * (HDV + SPAD) * sizeof(bf16) +
         4 * (size_t)BQ * sizeof(float);
}

template <int HDQK, int HDV>
constexpr size_t dq_mma_smem_bytes() {    // q, dO; 2 stages of k, v
  return (size_t)(BQ + 2 * BK) * (HDQK + SPAD) * sizeof(bf16) +
         (size_t)(BQ + 2 * BK) * (HDV + SPAD) * sizeof(bf16);
}

// The live tiles of a run: tile_live(k0, q0) over t = 0 .. n - 1 as the
// q-tile (over_q: the tile's first query at position q_start + t BQ) or
// the k-tile, with the other fixed at `at` (k0, or the q-tile's first
// position); each condition is monotone in either, so they are one run
// lo .. hi (empty when lo > hi).
__device__ __forceinline__ void live_run(int n, int at, bool over_q,
                                         int q_start, int k_len, int causal,
                                         int window, int& lo, int& hi) {
  lo = n;
  hi = -1;
  for (int t = 0; t < n; ++t) {
    const bool live =
        over_q ? tile_live(at, q_start + t * BQ, k_len, causal, window)
               : tile_live(t * BK, at, k_len, causal, window);
    if (live) {
      lo = min(lo, t);
      hi = t;
    }
  }
}

// ---------------------------------------------------------------------------
// 2. dk, dv of one k-tile of one key/value head, on the tensor cores (PART:
//    both, or dv or dk alone; CW of the gradient's columns from col0)
// ---------------------------------------------------------------------------
template <int HDQK, int HDV, int PART, int CW>
__global__ void __launch_bounds__(MMA_THREADS, 2) flash_bwd_dkdv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk,
    int q_start, int H, int Kh, int k_len, int causal, int window,
    float scale, int col0) {
  static_assert(HDQK % 16 == 0 && HDV % 16 == 0 && CW % 16 == 0,
                "head width");
  static_assert(PART != DKDV || (HDQK == HDV && CW == HDQK), "both at once");
  constexpr bool DO_DV = PART != DK;     // dv += p^T dO
  constexpr bool DO_DK = PART != DV;     // dp^T, ds^T and dk += ds^T q
  constexpr int RQ = HDQK + SPAD, RV = HDV + SPAD;
  constexpr int KQ = HDQK / 16;          // k16 steps of k q^T
  constexpr int KV = HDV / 16;           // and of v dO^T
  constexpr int KMAX = KQ > KV ? KQ : KV;
  constexpr int NT = CW / 8;             // n8 tiles of the launch's columns
  constexpr int QSUB = Qsub<CW, PART>::value;
  static_assert(BQ % QSUB == 0 && QSUB % 16 == 0, "query passes");
  constexpr int ST = QSUB / 8;           // n8 tiles (query octets) of a pass
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [BK][RQ]
  bf16* Qs = Ks + BK * RQ;                         // [2][BQ][RQ]
  bf16* Vs = Qs + 2 * BQ * RQ;                     // [BK][RV]
  bf16* Ds = Vs + BK * RV;                         // [2][BQ][RV] dO
  float* lse_s = reinterpret_cast<float*>(Ds + 2 * BQ * RV);  // [2][BQ]
  float* del_s = lse_s + 2 * BQ;                               // [2][BQ]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;  // fragment row, column pair
  // k-tile 0 first: under a causal mask it has the most live q-tiles
  const int kh = blockIdx.x, k0 = blockIdx.y * BK, b = blockIdx.z;
  const int G = H / Kh;
  const size_t q_stride = (size_t)H * HDQK, o_stride = (size_t)H * HDV;
  const size_t k_stride = (size_t)Kh * HDQK, v_stride = (size_t)Kh * HDV;
  const size_t k_base = (size_t)b * Sk * k_stride + (size_t)kh * HDQK;
  const size_t v_base = (size_t)b * Sk * v_stride + (size_t)kh * HDV;

  int qt_lo, qt_hi;
  live_run((Sq + BQ - 1) / BQ, k0, true, q_start, k_len, causal, window,
           qt_lo, qt_hi);
  const int n_run = qt_hi - qt_lo + 1;
  const int total = n_run > 0 ? G * n_run : 0;  // (head, q-tile) steps

  // step it's q, dO tiles into stage st (cp.async), and the row value
  // (lse for tid < BQ, delta for the next BQ threads) this thread loads
  auto issue = [&](int it, int st) {
    const int h = kh * G + it / n_run;
    const int q0 = (qt_lo + it % n_run) * BQ;
    load_tile<HDQK, MMA_THREADS>(
        Qs + st * BQ * RQ, q + (size_t)b * Sq * q_stride + (size_t)h * HDQK,
        q_stride, q0, Sq);
    load_tile<HDV, MMA_THREADS>(
        Ds + st * BQ * RV, dout + (size_t)b * Sq * o_stride + (size_t)h * HDV,
        o_stride, q0, Sq);
    const int pos = q0 + tid % BQ;
    const size_t row = ((size_t)b * Sq + pos) * H + h;
    return pos < Sq ? (tid < BQ ? lse[row] : delta[row]) : 0.f;
  };

  load_tile<HDQK, MMA_THREADS>(Ks, k + k_base, k_stride, k0, Sk);
  if constexpr (DO_DK)
    load_tile<HDV, MMA_THREADS>(Vs, v + v_base, v_stride, k0, Sk);
  if (total > 0) {
    const float x = issue(0, 0);
    (tid < BQ ? lse_s : del_s)[tid % BQ] = x;
  }
  cp_async_commit();

  const int row_w = 16 * warp;           // the warp's first key in the tile
  float dka[DO_DK ? NT : 1][4], dva[DO_DV ? NT : 1][4];
#pragma unroll
  for (int n = 0; n < (DO_DK ? NT : 1); ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dka[n][c] = 0.f;
#pragma unroll
  for (int n = 0; n < (DO_DV ? NT : 1); ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dva[n][c] = 0.f;

  for (int it = 0; it < total; ++it) {
    const int st = it & 1;
    float next = 0.f;
    if (it + 1 < total) {                // the next step, into the other stage
      next = issue(it + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = (qt_lo + it % n_run) * BQ;  // the tile's first row
    const int qa0 = q_start + q0;              // and its position
    const bf16* Qt = Qs + st * BQ * RQ;
    const bf16* Dt = Ds + st * BQ * RV;
    const float* lse_t = lse_s + st * BQ;
    const float* del_t = del_s + st * BQ;
    const bool edge = k0 + BK > k_len || (causal && k0 + BK - 1 > qa0) ||
                      (window > 0 && k0 <= qa0 + BQ - 1 - window) ||
                      q0 + BQ > Sq;

#pragma unroll
    for (int qs = 0; qs < BQ; qs += QSUB) {
      // s^T = k q^T and dp^T = v dO^T: query octet n of the pass in [n]
      float sT[ST][4], dpT[ST][4];
#pragma unroll
      for (int n = 0; n < ST; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) sT[n][c] = dpT[n][c] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KMAX; ++ks) {
        const bool on_q = ks < KQ, on_v = DO_DK && ks < KV;
        uint32_t ka[4], va[4];
        const int a_row = row_w + lane % 16, a_col = ks * 16 + (lane / 16) * 8;
        if (on_q) ldmatrix_x4(ka, smem_addr(Ks + a_row * RQ + a_col));
        if (on_v) ldmatrix_x4(va, smem_addr(Vs + a_row * RV + a_col));
#pragma unroll
        for (int n = 0; n < ST; n += 2) {
          const int b_row = qs + n * 8 + lane % 8 + (lane / 16) * 8;
          const int b_col = ks * 16 + ((lane / 8) % 2) * 8;
          uint32_t qf[4], df[4];
          if (on_q) {
            ldmatrix_x4(qf, smem_addr(Qt + b_row * RQ + b_col));
            mma_bf16(sT[n], ka, qf[0], qf[1]);
            mma_bf16(sT[n + 1], ka, qf[2], qf[3]);
          }
          if (on_v) {
            ldmatrix_x4(df, smem_addr(Dt + b_row * RV + b_col));
            mma_bf16(dpT[n], va, df[0], df[1]);
            mma_bf16(dpT[n + 1], va, df[2], df[3]);
          }
        }
      }
      // p^T and ds^T (element c of octet n: key row_w + g + 8 (c / 2),
      // query qs + 8 n + 2 tig + c % 2 of the tile)
#pragma unroll
      for (int n = 0; n < ST; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = qs + 8 * n + 2 * tig + c % 2;
          float x = sT[n][c] * scale;
          float p;
          if (edge) {
            const int kpos = k0 + row_w + g + 8 * (c / 2);
            x = key_live(qa0 + i, kpos, k_len, causal, window) ? x : NEG_INF;
            p = q0 + i < Sq ? expf(x - lse_t[i]) : 0.f;
          } else {
            p = expf(x - lse_t[i]);
          }
          sT[n][c] = p;
          if constexpr (DO_DK) dpT[n][c] = p * (dpT[n][c] - del_t[i]) * scale;
        }
      // dv += p^T dO, dk += ds^T q over the launch's columns, p and ds
      // split in two bf16 halves: queries qs + 16 j .. + 15 are octets 2 j
      // and 2 j + 1
#pragma unroll
      for (int j = 0; j < QSUB / 16; ++j) {
        const int row = qs + 16 * j + lane % 8 + ((lane / 8) % 2) * 8;
        const int col = col0 + (lane / 16) * 8;
        uint32_t hi[4], lo[4];
        if constexpr (DO_DV) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            split_bf16(sT[2 * j + r / 2][2 * (r % 2)],
                       sT[2 * j + r / 2][2 * (r % 2) + 1], hi[r], lo[r]);
#pragma unroll
          for (int n = 0; n < NT; n += 2) {
            uint32_t df[4];
            ldmatrix_x4_trans(df, smem_addr(Dt + row * RV + col + n * 8));
            mma_bf16(dva[n], hi, df[0], df[1]);
            mma_bf16(dva[n], lo, df[0], df[1]);
            mma_bf16(dva[n + 1], hi, df[2], df[3]);
            mma_bf16(dva[n + 1], lo, df[2], df[3]);
          }
        }
        if constexpr (DO_DK) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            split_bf16(dpT[2 * j + r / 2][2 * (r % 2)],
                       dpT[2 * j + r / 2][2 * (r % 2) + 1], hi[r], lo[r]);
#pragma unroll
          for (int n = 0; n < NT; n += 2) {
            uint32_t qf[4];
            ldmatrix_x4_trans(qf, smem_addr(Qt + row * RQ + col + n * 8));
            mma_bf16(dka[n], hi, qf[0], qf[1]);
            mma_bf16(dka[n], lo, qf[0], qf[1]);
            mma_bf16(dka[n + 1], hi, qf[2], qf[3]);
            mma_bf16(dka[n + 1], lo, qf[2], qf[3]);
          }
        }
      }
    }
    // the next step's row values into the other stage, whose readers
    // finished before this step's first barrier
    if (it + 1 < total) {
      float* dst = tid < BQ ? lse_s : del_s;
      dst[(st ^ 1) * BQ + tid % BQ] = next;
    }
    __syncthreads();                     // stage st is free for the refill
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = k0 + row_w + g + 8 * r;
    if (pos >= Sk) continue;
    bf16* dkr = dk + k_base + (size_t)pos * k_stride + col0 + 2 * tig;
    bf16* dvr = dv + v_base + (size_t)pos * v_stride + col0 + 2 * tig;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if constexpr (DO_DK)
        *reinterpret_cast<__nv_bfloat162*>(dkr + 8 * n) =
            __floats2bfloat162_rn(dka[n][2 * r], dka[n][2 * r + 1]);
      if constexpr (DO_DV)
        *reinterpret_cast<__nv_bfloat162*>(dvr + 8 * n) =
            __floats2bfloat162_rn(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dq of one q-tile of one head, on the tensor cores (CW of its columns
//    from col0)
// ---------------------------------------------------------------------------
template <int HDQK, int HDV, int CW>
__global__ void __launch_bounds__(MMA_THREADS, 2) flash_bwd_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int Sq, int Sk, int q_start, int H, int Kh,
    int k_len, int causal, int window, float scale, int col0) {
  static_assert(HDQK % 16 == 0 && HDV % 16 == 0 && CW % 16 == 0,
                "head width");
  constexpr int RQ = HDQK + SPAD, RV = HDV + SPAD;
  constexpr int KQ = HDQK / 16;          // k16 steps of q k^T
  constexpr int KV = HDV / 16;           // and of dO v^T
  constexpr int KMAX = KQ > KV ? KQ : KV;
  constexpr int NT = CW / 8;             // n8 tiles of the launch's columns
  constexpr int KSUB = Ksub<CW>::value;  // keys per pass of a k-tile
  static_assert(BK % KSUB == 0 && KSUB % 16 == 0, "key passes");
  constexpr int ST = KSUB / 8;           // n8 tiles (key octets) of a pass
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][RQ]
  bf16* Ks = Qs + BQ * RQ;                         // [2][BK][RQ]
  bf16* Ds = Ks + 2 * BK * RQ;                     // [BQ][RV] dO
  bf16* Vs = Ds + BQ * RV;                         // [2][BK][RV]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  // the last q-tile first: under a causal mask it has the most live k-tiles
  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the tile's first row
  const int qa0 = q_start + q0;                      // and its position
  const int b = blockIdx.z;
  const int kh = h / (H / Kh);
  const size_t q_stride = (size_t)H * HDQK, o_stride = (size_t)H * HDV;
  const size_t k_stride = (size_t)Kh * HDQK, v_stride = (size_t)Kh * HDV;
  const size_t q_base = (size_t)b * Sq * q_stride + (size_t)h * HDQK;
  const size_t o_base = (size_t)b * Sq * o_stride + (size_t)h * HDV;
  const size_t k_base = (size_t)b * Sk * k_stride + (size_t)kh * HDQK;
  const size_t v_base = (size_t)b * Sk * v_stride + (size_t)kh * HDV;

  int kt_lo, kt_hi;
  live_run((Sk + BK - 1) / BK, qa0, false, q_start, k_len, causal, window,
           kt_lo, kt_hi);

  load_tile<HDQK, MMA_THREADS>(Qs, q + q_base, q_stride, q0, Sq);
  load_tile<HDV, MMA_THREADS>(Ds, dout + o_base, o_stride, q0, Sq);
  if (kt_lo <= kt_hi) {
    load_tile<HDQK, MMA_THREADS>(Ks, k + k_base, k_stride, kt_lo * BK, Sk);
    load_tile<HDV, MMA_THREADS>(Vs, v + v_base, v_stride, kt_lo * BK, Sk);
  }
  cp_async_commit();

  const int row_w = 16 * warp;           // the warp's first row in the tile
  // rows g and g + 8 of the warp: lse and delta; p is 0 on rows past Sq
  float lse_r[2], del_r[2];
  bool in_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = q0 + row_w + g + 8 * r;
    const size_t row = ((size_t)b * Sq + pos) * H + h;
    in_r[r] = pos < Sq;
    lse_r[r] = in_r[r] ? lse[row] : 0.f;
    del_r[r] = in_r[r] ? delta[row] : 0.f;
  }
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int st = (kt - kt_lo) & 1;
    if (kt < kt_hi) {                    // the next tile, into the other stage
      load_tile<HDQK, MMA_THREADS>(Ks + (st ^ 1) * BK * RQ, k + k_base,
                                   k_stride, (kt + 1) * BK, Sk);
      load_tile<HDV, MMA_THREADS>(Vs + (st ^ 1) * BK * RV, v + v_base,
                                  v_stride, (kt + 1) * BK, Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + st * BK * RQ;
    const bf16* Vt = Vs + st * BK * RV;
    const int k0 = kt * BK;
    const bool edge = k0 + BK > k_len || (causal && k0 + BK - 1 > qa0) ||
                      (window > 0 && k0 <= qa0 + BQ - 1 - window);

#pragma unroll
    for (int kk = 0; kk < BK; kk += KSUB) {
      // s = q k^T and dp = dO v^T: key octet n of the pass in [n]
      float s[ST][4], dp[ST][4];
#pragma unroll
      for (int n = 0; n < ST; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KMAX; ++ks) {
        const bool on_q = ks < KQ, on_v = ks < KV;
        uint32_t qa[4], da[4];
        const int a_row = row_w + lane % 16, a_col = ks * 16 + (lane / 16) * 8;
        if (on_q) ldmatrix_x4(qa, smem_addr(Qs + a_row * RQ + a_col));
        if (on_v) ldmatrix_x4(da, smem_addr(Ds + a_row * RV + a_col));
#pragma unroll
        for (int n = 0; n < ST; n += 2) {
          const int b_row = kk + n * 8 + lane % 8 + (lane / 16) * 8;
          const int b_col = ks * 16 + ((lane / 8) % 2) * 8;
          uint32_t kf[4], vf[4];
          if (on_q) {
            ldmatrix_x4(kf, smem_addr(Kt + b_row * RQ + b_col));
            mma_bf16(s[n], qa, kf[0], kf[1]);
            mma_bf16(s[n + 1], qa, kf[2], kf[3]);
          }
          if (on_v) {
            ldmatrix_x4(vf, smem_addr(Vt + b_row * RV + b_col));
            mma_bf16(dp[n], da, vf[0], vf[1]);
            mma_bf16(dp[n + 1], da, vf[2], vf[3]);
          }
        }
      }
      // ds (element c of octet n: row g + 8 (c / 2), key
      // kk + 8 n + 2 tig + c % 2 of the tile)
#pragma unroll
      for (int n = 0; n < ST; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = c / 2;
          float x = s[n][c] * scale;
          if (edge) {
            const int qpos = qa0 + row_w + g + 8 * r;
            const int kpos = k0 + kk + 8 * n + 2 * tig + c % 2;
            x = key_live(qpos, kpos, k_len, causal, window) ? x : NEG_INF;
          }
          const float p = in_r[r] ? expf(x - lse_r[r]) : 0.f;
          s[n][c] = p * (dp[n][c] - del_r[r]) * scale;
        }
      // dq += ds k over the launch's columns, ds split in two bf16 halves:
      // keys kk + 16 j .. + 15 are octets 2 j and 2 j + 1
#pragma unroll
      for (int j = 0; j < KSUB / 16; ++j) {
        uint32_t sh[4], sl[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int n = 2 * j + r / 2, c = 2 * (r % 2);
          split_bf16(s[n][c], s[n][c + 1], sh[r], sl[r]);
        }
        const int row = kk + 16 * j + lane % 8 + ((lane / 8) % 2) * 8;
        const int col = col0 + (lane / 16) * 8;
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          uint32_t kf[4];
          ldmatrix_x4_trans(kf, smem_addr(Kt + row * RQ + col + n * 8));
          mma_bf16(acc[n], sh, kf[0], kf[1]);
          mma_bf16(acc[n], sl, kf[0], kf[1]);
          mma_bf16(acc[n + 1], sh, kf[2], kf[3]);
          mma_bf16(acc[n + 1], sl, kf[2], kf[3]);
        }
      }
    }
    __syncthreads();                     // stage st is free for the refill
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = q0 + row_w + g + 8 * r;
    if (pos >= Sq) continue;
    bf16* dqr = dq + q_base + (size_t)pos * q_stride + col0 + 2 * tig;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dqr + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
struct Args {                // the launch's shapes and masks
  int B, Sq, Sk, q_start, H, Kh, k_len, causal, window;
  float scale;
};

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int HDV>
cudaError_t launch_delta(const void* o, const void* dout, void* delta,
                         size_t rows, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((rows * 32 + THREADS - 1) / THREADS);
  flash_bwd_delta_kernel<T, HDV><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<float*>(delta), rows);
  return cudaGetLastError();
}

template <int HDQK, int HDV>
int launch_f32(const void* q, const void* k, const void* v, const void* o,
               const void* lse, const void* dout, void* dq, void* dk,
               void* dv, void* delta, const Args& a, cudaStream_t stream) {
  const int n_tq = (a.Sq + BQ - 1) / BQ, n_tk = (a.Sk + BK - 1) / BK;
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  const float* fdo = static_cast<const float*>(dout);
  const float* fl = static_cast<const float*>(lse);
  const float* fd = static_cast<const float*>(delta);
  float* fdq = static_cast<float*>(dq);
  float* fdk = static_cast<float*>(dk);
  float* fdv = static_cast<float*>(dv);
  const dim3 kv_grid(a.Kh, n_tk, a.B), q_grid(a.H, n_tq, a.B);
  cudaError_t err = launch_delta<float, HDV>(o, dout, delta,
                                             (size_t)a.B * a.Sq * a.H, stream);
  if (err != cudaSuccess) return (int)err;
  if constexpr (XBuf<HDQK, HDV>::value) {
    static_assert(HDQK == HDV, "three tiles at one width");
    constexpr int HD = HDQK;
    constexpr size_t s_dv = dkdv_x_smem_floats<HD, DV>() * sizeof(float);
    constexpr size_t s_dk = dkdv_x_smem_floats<HD, DK>() * sizeof(float);
    constexpr size_t s_dq = dq_x_smem_floats<HD>() * sizeof(float);
    static_assert(s_dk <= 232448 && s_dq <= 232448, "f32 tiles");
    err = set_smem(flash_bwd_dkdv_x_kernel<float, HD, DV>, s_dv);
    if (err == cudaSuccess)
      err = set_smem(flash_bwd_dkdv_x_kernel<float, HD, DK>, s_dk);
    if (err == cudaSuccess) err = set_smem(flash_bwd_dq_x_kernel<float, HD>, s_dq);
    if (err != cudaSuccess) return (int)err;
    if (n_tk > 0) {
      flash_bwd_dkdv_x_kernel<float, HD, DV><<<kv_grid, THREADS, s_dv,
                                               stream>>>(
          fq, fk, fv, fdo, fl, fd, fdk, fdv, a.Sq, a.Sk, a.q_start, a.H, a.Kh,
          a.k_len, a.causal, a.window, a.scale);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      flash_bwd_dkdv_x_kernel<float, HD, DK><<<kv_grid, THREADS, s_dk,
                                               stream>>>(
          fq, fk, fv, fdo, fl, fd, fdk, fdv, a.Sq, a.Sk, a.q_start, a.H, a.Kh,
          a.k_len, a.causal, a.window, a.scale);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    flash_bwd_dq_x_kernel<float, HD><<<q_grid, THREADS, s_dq, stream>>>(
        fq, fk, fv, fdo, fl, fd, fdq, a.Sq, a.Sk, a.q_start, a.H, a.Kh,
        a.k_len, a.causal, a.window, a.scale);
    return (int)cudaGetLastError();
  } else {
    constexpr size_t smem = smem_floats<HDQK, HDV>() * sizeof(float);
    err = set_smem(flash_bwd_dkdv_kernel<float, HDQK, HDV>, smem);
    if (err == cudaSuccess)
      err = set_smem(flash_bwd_dq_kernel<float, HDQK, HDV>, smem);
    if (err != cudaSuccess) return (int)err;
    if (n_tk > 0) {
      flash_bwd_dkdv_kernel<float, HDQK, HDV><<<kv_grid, THREADS, smem,
                                                stream>>>(
          fq, fk, fv, fdo, fl, fd, fdk, fdv, a.Sq, a.Sk, a.q_start, a.H, a.Kh,
          a.k_len, a.causal, a.window, a.scale);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    flash_bwd_dq_kernel<float, HDQK, HDV><<<q_grid, THREADS, smem, stream>>>(
        fq, fk, fv, fdo, fl, fd, fdq, a.Sq, a.Sk, a.q_start, a.H, a.Kh,
        a.k_len, a.causal, a.window, a.scale);
    return (int)cudaGetLastError();
  }
}

template <int HDQK, int HDV, int PART, int CW>
cudaError_t launch_dkdv_mma(const bf16* q, const bf16* k, const bf16* v,
                            const bf16* dout, const float* lse,
                            const float* delta, void* dk, void* dv,
                            const Args& a, cudaStream_t stream) {
  constexpr size_t smem = dkdv_mma_smem_bytes<HDQK, HDV>();
  static_assert(smem <= 232448, "bf16 dk/dv tiles");
  cudaError_t err = set_smem(flash_bwd_dkdv_mma_kernel<HDQK, HDV, PART, CW>,
                             smem);
  if (err != cudaSuccess) return err;
  constexpr int width = PART == DK ? HDQK : HDV;
  for (int col0 = 0; col0 < width; col0 += CW) {
    flash_bwd_dkdv_mma_kernel<HDQK, HDV, PART, CW>
        <<<dim3(a.Kh, (a.Sk + BK - 1) / BK, a.B), MMA_THREADS, smem,
           stream>>>(q, k, v, dout, lse, delta, static_cast<bf16*>(dk),
                     static_cast<bf16*>(dv), a.Sq, a.Sk, a.q_start, a.H,
                     a.Kh, a.k_len, a.causal, a.window, a.scale, col0);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int HDQK, int HDV>
int launch_bf16(const void* q, const void* k, const void* v, const void* o,
                const void* lse, const void* dout, void* dq, void* dk,
                void* dv, void* delta, const Args& a, cudaStream_t stream) {
  using P = Plan<HDQK, HDV>;
  constexpr int CWQ = P::cw_k;           // dq's columns a launch, as dk's
  constexpr size_t smem_q = dq_mma_smem_bytes<HDQK, HDV>();
  static_assert(smem_q <= 232448, "bf16 dq tiles");
  cudaError_t err = set_smem(flash_bwd_dq_mma_kernel<HDQK, HDV, CWQ>, smem_q);
  if (err == cudaSuccess)
    err = launch_delta<bf16, HDV>(o, dout, delta, (size_t)a.B * a.Sq * a.H,
                                  stream);
  if (err != cudaSuccess) return (int)err;
  const bf16* bq = static_cast<const bf16*>(q);
  const bf16* bk = static_cast<const bf16*>(k);
  const bf16* bv = static_cast<const bf16*>(v);
  const bf16* bdo = static_cast<const bf16*>(dout);
  const float* fl = static_cast<const float*>(lse);
  const float* fd = static_cast<const float*>(delta);
  if (a.Sk > 0) {
    if constexpr (P::split) {
      err = launch_dkdv_mma<HDQK, HDV, DV, P::cw_v>(bq, bk, bv, bdo, fl, fd,
                                                    dk, dv, a, stream);
      if (err == cudaSuccess)
        err = launch_dkdv_mma<HDQK, HDV, DK, P::cw_k>(bq, bk, bv, bdo, fl, fd,
                                                      dk, dv, a, stream);
    } else {
      err = launch_dkdv_mma<HDQK, HDV, DKDV, HDQK>(bq, bk, bv, bdo, fl, fd,
                                                   dk, dv, a, stream);
    }
    if (err != cudaSuccess) return (int)err;
  }
  for (int col0 = 0; col0 < HDQK; col0 += CWQ) {
    flash_bwd_dq_mma_kernel<HDQK, HDV, CWQ>
        <<<dim3(a.H, (a.Sq + BQ - 1) / BQ, a.B), MMA_THREADS, smem_q,
           stream>>>(bq, bk, bv, bdo, fl, fd, static_cast<bf16*>(dq), a.Sq,
                     a.Sk, a.q_start, a.H, a.Kh, a.k_len, a.causal, a.window,
                     a.scale, col0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

template <int HDQK, int HDV>
int launch(int dtype, const void* q, const void* k, const void* v,
           const void* o, const void* lse, const void* dout, void* dq,
           void* dk, void* dv, void* delta, const Args& a, cudaStream_t s) {
  if (dtype == 0)
    return launch_f32<HDQK, HDV>(q, k, v, o, lse, dout, dq, dk, dv, delta, a,
                                 s);
  if (dtype == 1)
    return launch_bf16<HDQK, HDV>(q, k, v, o, lse, dout, dq, dk, dv, delta, a,
                                  s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32 (the CUDA-core kernels), 1 bfloat16 (the tensor-core
// kernels), for q, k, v, o, dout, dq, dk and dv alike; (hd, hd_v) as
// flash_fill_launch takes them: (d, d) for d in 16, 32, 64, 128, 160, 256,
// and (192, 128); q and dq (B, Sq, H, hd), o and dout (B, Sq, H, hd_v), k
// and dk (B, Sk, Kh, hd), v and dv (B, Sk, Kh, hd_v), contiguous, 16-byte
// aligned; lse (B, Sq, H) float32 from the forward; delta (B, Sq, H)
// float32 scratch.  q_start and the masks as flash_fill_launch.  Launches
// on `stream`: delta, then dk/dv and dq (bf16: one dk/dv launch up to hd
// 128, dv and dk apart above, each in column halves at hd 256, dq in
// column halves at hd 256; f32: one dk/dv launch, dv and dk apart at hd
// 256; no dk/dv launch when Sk is 0).  Returns the CUDA error code of the
// first launch that fails (0 on success).
int flash_bwd_launch(int dtype, int hd, int hd_v, const void* q,
                     const void* k, const void* v, const void* o,
                     const void* lse, const void* dout, void* dq, void* dk,
                     void* dv, void* delta, int B, int Sq, int Sk,
                     int q_start, int H, int Kh, int k_len, int causal,
                     int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (Sk < 0 || Kh <= 0 || H % Kh) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{B, Sq, Sk, q_start, H, Kh, k_len, causal, window, scale};
#define K3_BWD(QK, V) \
  launch<QK, V>(dtype, q, k, v, o, lse, dout, dq, dk, dv, delta, a, s)
  if (hd == hd_v) {
    switch (hd) {
      case 16: return K3_BWD(16, 16);
      case 32: return K3_BWD(32, 32);
      case 64: return K3_BWD(64, 64);
      case 128: return K3_BWD(128, 128);
      case 160: return K3_BWD(160, 160);
      case 256: return K3_BWD(256, 256);
    }
  } else if (hd == 192 && hd_v == 128) {
    return K3_BWD(192, 128);
  }
#undef K3_BWD
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
