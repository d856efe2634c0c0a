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
// Three launches on one stream:
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
// row or column are one run, since each condition is monotone.  Rows and
// keys past S load as zeros and are not stored.
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
// * f32 (flash_bwd_dkdv_kernel, flash_bwd_dq_kernel) is the correctness
//   path: the CUDA-core kernels of the first version.  Tiles widened to f32
//   in shared memory (rows padded by one float), each of 256 threads owning
//   a 4 x 4 patch of the 64 x 64 score tile and a 4 x hd/16 patch of its
//   output tile.
//
// What bounds it.  Per live (query, key) pair the function needs 10 hd
// FLOP (s, dp, dv, dk, dq: 2 hd each) against reading q, k, v, O, dO once
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
// 64 rows of one head, rows row0 .. row0 + 63 of a (S, heads, HD) slab
// with row_stride elements between rows, as f32 into dst[64][HD + 1];
// rows past S are zeros.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          size_t row_stride, int row0,
                                          int S) {
  constexpr int RS = HD + 1;
  for (int e = threadIdx.x; e < 64 * HD; e += THREADS) {
    const int row = e / HD, d = e % HD;
    const int pos = row0 + row;
    dst[row * RS + d] =
        pos < S ? to_f32(src[(size_t)pos * row_stride + d]) : 0.f;
  }
}

// out[a][c] = sum_d A[4 ty + a][d] B[tx + 16 c][d] over one 64 x 64 tile
// pair (rows of A and B HD + 1 floats apart).
template <int HD>
__device__ __forceinline__ void tile_dots(float (&out)[4][4], const float* A,
                                          const float* B, int ty, int tx) {
  constexpr int RS = HD + 1;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) out[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
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

// p and ds of the thread's patch of one (q-tile, k-tile) pair, from the
// q/dO tiles (Qs, Ds), the k/v tiles (Ks, Vs) and the rows' lse and delta:
// exactly _flash_core_bwd's arithmetic, s = (q . k) * scale, masked to
// -1e30, p = exp(s - lse), ds = p (dp - delta) * scale.  Rows at or past
// S get p = ds = 0.
template <int HD>
__device__ __forceinline__ void p_and_ds(float (&p)[4][4], float (&ds)[4][4],
                                         const float* Qs, const float* Ds,
                                         const float* Ks, const float* Vs,
                                         const float* lse_s,
                                         const float* del_s, int q0, int k0,
                                         int S, int k_len, int causal,
                                         int window, float scale, int ty,
                                         int tx) {
  float dp[4][4];
  tile_dots<HD>(p, Qs, Ks, ty, tx);
  tile_dots<HD>(dp, Ds, Vs, ty, tx);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = 4 * ty + a;
    const int qpos = q0 + i;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kpos = k0 + tx + 16 * c;
      const float s = key_live(qpos, kpos, k_len, causal, window)
                          ? p[a][c] * scale : NEG_INF;
      const float pr = qpos < S ? expf(s - lse_s[i]) : 0.f;
      p[a][c] = pr;
      ds[a][c] = pr * (dp[a][c] - del_s[i]) * scale;
    }
  }
}

template <int HD>
constexpr size_t smem_floats() {   // four 64-row tiles, p, ds, lse, delta
  return 4 * (size_t)64 * (HD + 1) + 2 * (size_t)BQ * PS + 2 * BQ;
}

// ---------------------------------------------------------------------------
// 1. delta = rowsum(dO * O), one warp per (position, head) row
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) flash_bwd_delta_kernel(
    const T* __restrict__ o, const T* __restrict__ dout,
    float* __restrict__ delta, size_t rows) {
  const size_t row = ((size_t)blockIdx.x * THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* orow = o + row * HD;
  const T* drow = dout + row * HD;
  float acc = 0.f;
  for (int d = lane; d < HD; d += 32)
    acc = fmaf(to_f32(drow[d]), to_f32(orow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ---------------------------------------------------------------------------
// 2. dk, dv of one k-tile of one key/value head
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int S, int H, int Kh, int k_len, int causal, int window, float scale) {
  constexpr int RS = HD + 1;
  constexpr int NC = HD / 16;          // output columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;                    // [BK][RS]
  float* Vs = Ks + BK * RS;            // [BK][RS]
  float* Qs = Vs + BK * RS;            // [BQ][RS]
  float* Ds = Qs + BQ * RS;            // [BQ][RS] dO
  float* Ps = Ds + BQ * RS;            // [BQ][PS] p
  float* Ss = Ps + BQ * PS;            // [BQ][PS] ds
  float* lse_s = Ss + BQ * PS;         // [BQ]
  float* del_s = lse_s + BQ;           // [BQ]

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  // k-tile 0 first: under a causal mask it has the most live q-tiles
  const int kh = blockIdx.x, k0 = blockIdx.y * BK, b = blockIdx.z;
  const int G = H / Kh;
  const size_t q_stride = (size_t)H * HD;
  const size_t kv_stride = (size_t)Kh * HD;
  const size_t kv_base = (size_t)b * S * kv_stride + (size_t)kh * HD;
  load_rows<T, HD>(Ks, k + kv_base, kv_stride, k0, S);
  load_rows<T, HD>(Vs, v + kv_base, kv_stride, k0, S);

  float dka[4][NC], dva[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) dka[a][c] = dva[a][c] = 0.f;

  const int n_q = (S + BQ - 1) / BQ;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const size_t q_base = (size_t)b * S * q_stride + (size_t)h * HD;
    for (int qt = 0; qt < n_q; ++qt) {
      const int q0 = qt * BQ;
      if (!tile_live(k0, q0, k_len, causal, window)) continue;  // uniform
      __syncthreads();                 // the last pair's readers are done
      load_rows<T, HD>(Qs, q + q_base, q_stride, q0, S);
      load_rows<T, HD>(Ds, dout + q_base, q_stride, q0, S);
      if (tid < BQ) {
        const int pos = q0 + tid;
        const size_t row = ((size_t)b * S + pos) * H + h;
        lse_s[tid] = pos < S ? lse[row] : 0.f;
        del_s[tid] = pos < S ? delta[row] : 0.f;
      }
      __syncthreads();
      float p[4][4], ds[4][4];
      p_and_ds<HD>(p, ds, Qs, Ds, Ks, Vs, lse_s, del_s, q0, k0, S, k_len,
                   causal, window, scale, ty, tx);
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
        float pj[4], sj[4], dov[NC], qv[NC];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pj[a] = Ps[i * PS + 4 * ty + a];
          sj[a] = Ss[i * PS + 4 * ty + a];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dov[c] = Ds[i * RS + tx + 16 * c];
          qv[c] = Qs[i * RS + tx + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            dva[a][c] = fmaf(pj[a], dov[c], dva[a][c]);
            dka[a][c] = fmaf(sj[a], qv[c], dka[a][c]);
          }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int pos = k0 + 4 * ty + a;
    if (pos >= S) continue;
    T* dkr = dk + kv_base + (size_t)pos * kv_stride;
    T* dvr = dv + kv_base + (size_t)pos * kv_stride;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dkr[tx + 16 * c] = from_f32<T>(dka[a][c]);
      dvr[tx + 16 * c] = from_f32<T>(dva[a][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dq of one q-tile of one head
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int S, int H,
    int Kh, int k_len, int causal, int window, float scale) {
  constexpr int RS = HD + 1;
  constexpr int NC = HD / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * RS;
  float* Qs = Vs + BK * RS;
  float* Ds = Qs + BQ * RS;
  float* Ss = Ds + BQ * RS + BQ * PS;  // ds (the p tile is not needed)
  float* lse_s = Ss + BQ * PS;
  float* del_s = lse_s + BQ;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  // the last q-tile first: under a causal mask it has the most live k-tiles
  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = blockIdx.z;
  const int kh = h / (H / Kh);
  const size_t q_stride = (size_t)H * HD;
  const size_t kv_stride = (size_t)Kh * HD;
  const size_t q_base = (size_t)b * S * q_stride + (size_t)h * HD;
  const size_t kv_base = (size_t)b * S * kv_stride + (size_t)kh * HD;
  load_rows<T, HD>(Qs, q + q_base, q_stride, q0, S);
  load_rows<T, HD>(Ds, dout + q_base, q_stride, q0, S);
  if (tid < BQ) {
    const int pos = q0 + tid;
    const size_t row = ((size_t)b * S + pos) * H + h;
    lse_s[tid] = pos < S ? lse[row] : 0.f;
    del_s[tid] = pos < S ? delta[row] : 0.f;
  }

  float dqa[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) dqa[a][c] = 0.f;

  const int n_k = (S + BK - 1) / BK;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    if (!tile_live(k0, q0, k_len, causal, window)) continue;  // uniform
    __syncthreads();                   // the last tile's readers are done
    load_rows<T, HD>(Ks, k + kv_base, kv_stride, k0, S);
    load_rows<T, HD>(Vs, v + kv_base, kv_stride, k0, S);
    __syncthreads();
    float p[4][4], ds[4][4];
    p_and_ds<HD>(p, ds, Qs, Ds, Ks, Vs, lse_s, del_s, q0, k0, S, k_len,
                 causal, window, scale, ty, tx);
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
      for (int c = 0; c < NC; ++c) kv[c] = Ks[j * RS + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < NC; ++c) dqa[a][c] = fmaf(sv[a], kv[c], dqa[a][c]);
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int pos = q0 + 4 * ty + a;
    if (pos >= S) continue;
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
// Queries per pass of the dk/dv kernel: at hd 128, passes of 32 spill
// (255 registers and 72 bytes); passes of 16 fit in 248.
template <int HD>
struct Qsub { static constexpr int value = HD >= 128 ? 16 : 32; };
static_assert(BQ == 16 * MMA_WARPS && BQ == BK && BK == TILE_ROWS,
              "mma tiling");
static_assert(MMA_THREADS == 2 * BQ, "one lse or delta load a thread");

template <int HD>
constexpr size_t dkdv_mma_smem_bytes() {  // k, v; 2 stages of q, dO; lse, delta
  return (size_t)(2 * BK + 4 * BQ) * (HD + SPAD) * sizeof(bf16) +
         4 * (size_t)BQ * sizeof(float);
}

template <int HD>
constexpr size_t dq_mma_smem_bytes() {    // q, dO; 2 stages of k, v
  return (size_t)(2 * BQ + 4 * BK) * (HD + SPAD) * sizeof(bf16);
}

// The live tiles of a run: tile_live(k0, q0) over t = 0 .. n - 1 as the
// q-tile (over_q) or the k-tile, with the other fixed at `at`; each
// condition is monotone in either, so they are one run lo .. hi (empty
// when lo > hi).
__device__ __forceinline__ void live_run(int n, int at, bool over_q,
                                         int k_len, int causal, int window,
                                         int& lo, int& hi) {
  lo = n;
  hi = -1;
  for (int t = 0; t < n; ++t) {
    const bool live = over_q ? tile_live(at, t * BQ, k_len, causal, window)
                             : tile_live(t * BK, at, k_len, causal, window);
    if (live) {
      lo = min(lo, t);
      hi = t;
    }
  }
}

// ---------------------------------------------------------------------------
// 2. dk, dv of one k-tile of one key/value head, on the tensor cores
// ---------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(MMA_THREADS, 2) flash_bwd_dkdv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H, int Kh,
    int k_len, int causal, int window, float scale) {
  static_assert(HD % 16 == 0, "head width");
  constexpr int RS = HD + SPAD;
  constexpr int KSTEPS = HD / 16;        // k16 steps of k q^T and v dO^T
  constexpr int NT = HD / 8;             // n8 tiles of dk and dv
  constexpr int QSUB = Qsub<HD>::value;
  static_assert(BQ % QSUB == 0 && QSUB % 16 == 0, "query passes");
  constexpr int ST = QSUB / 8;           // n8 tiles (query octets) of a pass
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [BK][RS]
  bf16* Vs = Ks + BK * RS;                         // [BK][RS]
  bf16* Qs = Vs + BK * RS;                         // [2][BQ][RS]
  bf16* Ds = Qs + 2 * BQ * RS;                     // [2][BQ][RS] dO
  float* lse_s = reinterpret_cast<float*>(Ds + 2 * BQ * RS);  // [2][BQ]
  float* del_s = lse_s + 2 * BQ;                               // [2][BQ]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;  // fragment row, column pair
  // k-tile 0 first: under a causal mask it has the most live q-tiles
  const int kh = blockIdx.x, k0 = blockIdx.y * BK, b = blockIdx.z;
  const int G = H / Kh;
  const size_t q_stride = (size_t)H * HD;
  const size_t kv_stride = (size_t)Kh * HD;
  const size_t kv_base = (size_t)b * S * kv_stride + (size_t)kh * HD;
  const size_t q_batch = (size_t)b * S * q_stride;

  int qt_lo, qt_hi;
  live_run((S + BQ - 1) / BQ, k0, true, k_len, causal, window, qt_lo, qt_hi);
  const int n_run = qt_hi - qt_lo + 1;
  const int total = n_run > 0 ? G * n_run : 0;  // (head, q-tile) steps

  // step it's q, dO tiles into stage st (cp.async), and the row value
  // (lse for tid < BQ, delta for the next BQ threads) this thread loads
  auto issue = [&](int it, int st) {
    const int h = kh * G + it / n_run;
    const int q0 = (qt_lo + it % n_run) * BQ;
    const size_t q_base = q_batch + (size_t)h * HD;
    load_tile<HD, MMA_THREADS>(Qs + st * BQ * RS, q + q_base, q_stride, q0, S);
    load_tile<HD, MMA_THREADS>(Ds + st * BQ * RS, dout + q_base, q_stride, q0,
                               S);
    const int pos = q0 + tid % BQ;
    const size_t row = ((size_t)b * S + pos) * H + h;
    return pos < S ? (tid < BQ ? lse[row] : delta[row]) : 0.f;
  };

  load_tile<HD, MMA_THREADS>(Ks, k + kv_base, kv_stride, k0, S);
  load_tile<HD, MMA_THREADS>(Vs, v + kv_base, kv_stride, k0, S);
  if (total > 0) {
    const float x = issue(0, 0);
    (tid < BQ ? lse_s : del_s)[tid % BQ] = x;
  }
  cp_async_commit();

  const int row_w = 16 * warp;           // the warp's first key in the tile
  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dka[n][c] = dva[n][c] = 0.f;

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
    const int q0 = (qt_lo + it % n_run) * BQ;
    const bf16* Qt = Qs + st * BQ * RS;
    const bf16* Dt = Ds + st * BQ * RS;
    const float* lse_t = lse_s + st * BQ;
    const float* del_t = del_s + st * BQ;
    const bool edge = k0 + BK > k_len || (causal && k0 + BK - 1 > q0) ||
                      (window > 0 && k0 <= q0 + BQ - 1 - window) ||
                      q0 + BQ > S;

#pragma unroll
    for (int qs = 0; qs < BQ; qs += QSUB) {
      // s^T = k q^T and dp^T = v dO^T: query octet n of the pass in [n]
      float sT[ST][4], dpT[ST][4];
#pragma unroll
      for (int n = 0; n < ST; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) sT[n][c] = dpT[n][c] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        uint32_t ka[4], va[4];
        const int a_off = (row_w + lane % 16) * RS + ks * 16 + (lane / 16) * 8;
        ldmatrix_x4(ka, smem_addr(Ks + a_off));
        ldmatrix_x4(va, smem_addr(Vs + a_off));
#pragma unroll
        for (int n = 0; n < ST; n += 2) {
          const int b_off = (qs + n * 8 + lane % 8 + (lane / 16) * 8) * RS +
                            ks * 16 + ((lane / 8) % 2) * 8;
          uint32_t qf[4], df[4];
          ldmatrix_x4(qf, smem_addr(Qt + b_off));
          mma_bf16(sT[n], ka, qf[0], qf[1]);
          mma_bf16(sT[n + 1], ka, qf[2], qf[3]);
          ldmatrix_x4(df, smem_addr(Dt + b_off));
          mma_bf16(dpT[n], va, df[0], df[1]);
          mma_bf16(dpT[n + 1], va, df[2], df[3]);
        }
      }
      // p^T and ds^T (element c of octet n: key row_w + g + 8 (c / 2),
      // query qs + 8 n + 2 tig + c % 2 of the tile)
#pragma unroll
      for (int n = 0; n < ST; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = qs + 8 * n + 2 * tig + c % 2;
          const int qpos = q0 + i;
          float x = sT[n][c] * scale;
          float p;
          if (edge) {
            const int kpos = k0 + row_w + g + 8 * (c / 2);
            x = key_live(qpos, kpos, k_len, causal, window) ? x : NEG_INF;
            p = qpos < S ? expf(x - lse_t[i]) : 0.f;
          } else {
            p = expf(x - lse_t[i]);
          }
          sT[n][c] = p;
          dpT[n][c] = p * (dpT[n][c] - del_t[i]) * scale;
        }
      // dv += p^T dO, dk += ds^T q, p and ds split in two bf16 halves:
      // queries qs + 16 j .. + 15 are octets 2 j and 2 j + 1
#pragma unroll
      for (int j = 0; j < QSUB / 16; ++j) {
        const int row = qs + 16 * j + lane % 8 + ((lane / 8) % 2) * 8;
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_bf16(sT[2 * j + r / 2][2 * (r % 2)],
                     sT[2 * j + r / 2][2 * (r % 2) + 1], hi[r], lo[r]);
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          uint32_t df[4];
          ldmatrix_x4_trans(df, smem_addr(Dt + row * RS + n * 8 +
                                          (lane / 16) * 8));
          mma_bf16(dva[n], hi, df[0], df[1]);
          mma_bf16(dva[n], lo, df[0], df[1]);
          mma_bf16(dva[n + 1], hi, df[2], df[3]);
          mma_bf16(dva[n + 1], lo, df[2], df[3]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_bf16(dpT[2 * j + r / 2][2 * (r % 2)],
                     dpT[2 * j + r / 2][2 * (r % 2) + 1], hi[r], lo[r]);
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          uint32_t qf[4];
          ldmatrix_x4_trans(qf, smem_addr(Qt + row * RS + n * 8 +
                                          (lane / 16) * 8));
          mma_bf16(dka[n], hi, qf[0], qf[1]);
          mma_bf16(dka[n], lo, qf[0], qf[1]);
          mma_bf16(dka[n + 1], hi, qf[2], qf[3]);
          mma_bf16(dka[n + 1], lo, qf[2], qf[3]);
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
    if (pos >= S) continue;
    bf16* dkr = dk + kv_base + (size_t)pos * kv_stride + 2 * tig;
    bf16* dvr = dv + kv_base + (size_t)pos * kv_stride + 2 * tig;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dkr + 8 * n) =
          __floats2bfloat162_rn(dka[n][2 * r], dka[n][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvr + 8 * n) =
          __floats2bfloat162_rn(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dq of one q-tile of one head, on the tensor cores
// ---------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(MMA_THREADS, 2) flash_bwd_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int S, int H, int Kh, int k_len, int causal,
    int window, float scale) {
  static_assert(HD % 16 == 0, "head width");
  constexpr int RS = HD + SPAD;
  constexpr int KSTEPS = HD / 16;        // k16 steps of q k^T and dO v^T
  constexpr int NT = HD / 8;             // n8 tiles of dq
  constexpr int ST = BK / 8;             // n8 tiles (key octets) of a k-tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][RS]
  bf16* Ds = Qs + BQ * RS;                         // [BQ][RS] dO
  bf16* Ks = Ds + BQ * RS;                         // [2][BK][RS]
  bf16* Vs = Ks + 2 * BK * RS;                     // [2][BK][RS]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  // the last q-tile first: under a causal mask it has the most live k-tiles
  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = blockIdx.z;
  const int kh = h / (H / Kh);
  const size_t q_stride = (size_t)H * HD;
  const size_t kv_stride = (size_t)Kh * HD;
  const size_t q_base = (size_t)b * S * q_stride + (size_t)h * HD;
  const size_t kv_base = (size_t)b * S * kv_stride + (size_t)kh * HD;

  int kt_lo, kt_hi;
  live_run((S + BK - 1) / BK, q0, false, k_len, causal, window, kt_lo, kt_hi);

  load_tile<HD, MMA_THREADS>(Qs, q + q_base, q_stride, q0, S);
  load_tile<HD, MMA_THREADS>(Ds, dout + q_base, q_stride, q0, S);
  if (kt_lo <= kt_hi) {
    load_tile<HD, MMA_THREADS>(Ks, k + kv_base, kv_stride, kt_lo * BK, S);
    load_tile<HD, MMA_THREADS>(Vs, v + kv_base, kv_stride, kt_lo * BK, S);
  }
  cp_async_commit();

  const int row_w = 16 * warp;           // the warp's first row in the tile
  // rows g and g + 8 of the warp: lse and delta; p is 0 on rows past S
  float lse_r[2], del_r[2];
  bool in_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = q0 + row_w + g + 8 * r;
    const size_t row = ((size_t)b * S + pos) * H + h;
    in_r[r] = pos < S;
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
      load_tile<HD, MMA_THREADS>(Ks + (st ^ 1) * BK * RS, k + kv_base,
                                 kv_stride, (kt + 1) * BK, S);
      load_tile<HD, MMA_THREADS>(Vs + (st ^ 1) * BK * RS, v + kv_base,
                                 kv_stride, (kt + 1) * BK, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + st * BK * RS;
    const bf16* Vt = Vs + st * BK * RS;

    // s = q k^T and dp = dO v^T: key octet n in [n]
    float s[ST][4], dp[ST][4];
#pragma unroll
    for (int n = 0; n < ST; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      uint32_t qa[4], da[4];
      const int a_off = (row_w + lane % 16) * RS + ks * 16 + (lane / 16) * 8;
      ldmatrix_x4(qa, smem_addr(Qs + a_off));
      ldmatrix_x4(da, smem_addr(Ds + a_off));
#pragma unroll
      for (int n = 0; n < ST; n += 2) {
        const int b_off = (n * 8 + lane % 8 + (lane / 16) * 8) * RS +
                          ks * 16 + ((lane / 8) % 2) * 8;
        uint32_t kf[4], vf[4];
        ldmatrix_x4(kf, smem_addr(Kt + b_off));
        mma_bf16(s[n], qa, kf[0], kf[1]);
        mma_bf16(s[n + 1], qa, kf[2], kf[3]);
        ldmatrix_x4(vf, smem_addr(Vt + b_off));
        mma_bf16(dp[n], da, vf[0], vf[1]);
        mma_bf16(dp[n + 1], da, vf[2], vf[3]);
      }
    }
    // ds (element c of octet n: row g + 8 (c / 2), key 8 n + 2 tig + c % 2)
    const int k0 = kt * BK;
    const bool edge = k0 + BK > k_len || (causal && k0 + BK - 1 > q0) ||
                      (window > 0 && k0 <= q0 + BQ - 1 - window);
#pragma unroll
    for (int n = 0; n < ST; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c / 2;
        float x = s[n][c] * scale;
        if (edge) {
          const int qpos = q0 + row_w + g + 8 * r;
          const int kpos = k0 + 8 * n + 2 * tig + c % 2;
          x = key_live(qpos, kpos, k_len, causal, window) ? x : NEG_INF;
        }
        const float p = in_r[r] ? expf(x - lse_r[r]) : 0.f;
        s[n][c] = p * (dp[n][c] - del_r[r]) * scale;
      }
    // dq += ds k, ds split in two bf16 halves: keys 16 j .. 16 j + 15 are
    // octets 2 j and 2 j + 1
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t sh[4], sl[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int n = 2 * j + r / 2, c = 2 * (r % 2);
        split_bf16(s[n][c], s[n][c + 1], sh[r], sl[r]);
      }
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t kf[4];
        ldmatrix_x4_trans(kf, smem_addr(Kt + (16 * j + lane % 8 +
                                              ((lane / 8) % 2) * 8) * RS +
                                        n * 8 + (lane / 16) * 8));
        mma_bf16(acc[n], sh, kf[0], kf[1]);
        mma_bf16(acc[n], sl, kf[0], kf[1]);
        mma_bf16(acc[n + 1], sh, kf[2], kf[3]);
        mma_bf16(acc[n + 1], sl, kf[2], kf[3]);
      }
    }
    __syncthreads();                     // stage st is free for the refill
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = q0 + row_w + g + 8 * r;
    if (pos >= S) continue;
    bf16* dqr = dq + q_base + (size_t)pos * q_stride + 2 * tig;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dqr + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int HD>
cudaError_t launch_delta(const void* o, const void* dout, void* delta,
                         size_t rows, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((rows * 32 + THREADS - 1) / THREADS);
  flash_bwd_delta_kernel<T, HD><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<float*>(delta), rows);
  return cudaGetLastError();
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, const void* o,
               const void* lse, const void* dout, void* dq, void* dk,
               void* dv, void* delta, int B, int S, int H, int Kh, int k_len,
               int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  cudaError_t err = set_smem(flash_bwd_dkdv_kernel<float, HD>, smem);
  if (err == cudaSuccess) err = set_smem(flash_bwd_dq_kernel<float, HD>, smem);
  if (err == cudaSuccess)
    err = launch_delta<float, HD>(o, dout, delta, (size_t)B * S * H, stream);
  if (err != cudaSuccess) return (int)err;
  const int n_t = (S + BQ - 1) / BQ;
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  const float* fdo = static_cast<const float*>(dout);
  const float* fl = static_cast<const float*>(lse);
  const float* fd = static_cast<const float*>(delta);
  flash_bwd_dkdv_kernel<float, HD><<<dim3(Kh, n_t, B), THREADS, smem,
                                     stream>>>(
      fq, fk, fv, fdo, fl, fd, static_cast<float*>(dk),
      static_cast<float*>(dv), S, H, Kh, k_len, causal, window, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<float, HD><<<dim3(H, n_t, B), THREADS, smem, stream>>>(
      fq, fk, fv, fdo, fl, fd, static_cast<float*>(dq), S, H, Kh, k_len,
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, const void* o,
                const void* lse, const void* dout, void* dq, void* dk,
                void* dv, void* delta, int B, int S, int H, int Kh,
                int k_len, int causal, int window, float scale,
                cudaStream_t stream) {
  const size_t smem_kv = dkdv_mma_smem_bytes<HD>();
  const size_t smem_q = dq_mma_smem_bytes<HD>();
  cudaError_t err = set_smem(flash_bwd_dkdv_mma_kernel<HD>, smem_kv);
  if (err == cudaSuccess)
    err = set_smem(flash_bwd_dq_mma_kernel<HD>, smem_q);
  if (err == cudaSuccess)
    err = launch_delta<bf16, HD>(o, dout, delta, (size_t)B * S * H, stream);
  if (err != cudaSuccess) return (int)err;
  const int n_t = (S + BQ - 1) / BQ;
  const bf16* bq = static_cast<const bf16*>(q);
  const bf16* bk = static_cast<const bf16*>(k);
  const bf16* bv = static_cast<const bf16*>(v);
  const bf16* bdo = static_cast<const bf16*>(dout);
  const float* fl = static_cast<const float*>(lse);
  const float* fd = static_cast<const float*>(delta);
  flash_bwd_dkdv_mma_kernel<HD><<<dim3(Kh, n_t, B), MMA_THREADS, smem_kv,
                                  stream>>>(
      bq, bk, bv, bdo, fl, fd, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      S, H, Kh, k_len, causal, window, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  flash_bwd_dq_mma_kernel<HD><<<dim3(H, n_t, B), MMA_THREADS, smem_q,
                                stream>>>(
      bq, bk, bv, bdo, fl, fd, static_cast<bf16*>(dq), S, H, Kh, k_len,
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(int dtype, const void* q, const void* k, const void* v,
           const void* o, const void* lse, const void* dout, void* dq,
           void* dk, void* dv, void* delta, int B, int S, int H, int Kh,
           int k_len, int causal, int window, float scale, cudaStream_t s) {
  if (dtype == 0)
    return launch_f32<HD>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, S, H, Kh, k_len, causal, window, scale, s);
  if (dtype == 1)
    return launch_bf16<HD>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, S, H, Kh, k_len, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32 (the CUDA-core kernels), 1 bfloat16 (the tensor-core
// kernels), for q, k, v, o, dout, dq, dk and dv alike; hd: 16, 32, 64 or
// 128; q, o, dout, dq (B, S, H, hd) and k, v, dk, dv (B, S, Kh, hd),
// contiguous, 16-byte aligned; lse (B, S, H) float32 from the forward;
// delta (B, S, H) float32 scratch.  Masks as flash_fill_launch.  Three
// CUDA launches on `stream`.  Returns the CUDA error code of the first
// launch that fails (0 on success).
int flash_bwd_launch(int dtype, int hd, const void* q, const void* k,
                     const void* v, const void* o, const void* lse,
                     const void* dout, void* dq, void* dk, void* dv,
                     void* delta, int B, int S, int H, int Kh, int k_len,
                     int causal, int window, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (Kh <= 0 || H % Kh) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(dtype, q, k, v, o, lse, dout, dq, dk, dv, delta, B, S, H, Kh, k_len, causal, window, scale, s);
    case 32: return launch<32>(dtype, q, k, v, o, lse, dout, dq, dk, dv, delta, B, S, H, Kh, k_len, causal, window, scale, s);
    case 64: return launch<64>(dtype, q, k, v, o, lse, dout, dq, dk, dv, delta, B, S, H, Kh, k_len, causal, window, scale, s);
    case 128: return launch<128>(dtype, q, k, v, o, lse, dout, dq, dk, dv, delta, B, S, H, Kh, k_len, causal, window, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
