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
// with p recomputed in f32 (never rounded to bf16: the forward's bf16 p is
// a forward-only choice of the model path), every product accumulated in
// f32 and the results stored in the inputs' type.  Grouped-query attention
// sums dk and dv over the G query heads of a key/value head.
//
// Three launches on one stream:
//   1. delta, one warp per (position, head) row;
//   2. dk and dv, one block per (key/value head, 64-row k-tile, batch row):
//      the k- and v-tiles stay in shared memory while the block walks the
//      live q-tiles of each of the G query heads, and dk, dv accumulate in
//      registers;
//   3. dq, one block per (head, 64-row q-tile, batch row): the q- and
//      dO-tiles stay while the block walks the live k-tiles.
// Each output element is written by exactly one block, so no atomics:
// the gradients are the same bits from run to run, and a resumed training
// run can be held bit-equal to an unbroken one.  A (q-tile, k-tile) pair
// is visited when the forward's tile test (kernel.py::live_block) passes,
// in both launches.  Rows and keys past S load as zeros and are not
// stored.
//
// Tiles sit in shared memory as f32, rows padded by one float so that a
// warp reading one column of 16 rows hits 16 banks.  Each of the 256
// threads owns a 4 x 4 patch of the 64 x 64 score tile (rows 4 ty + a,
// keys tx + 16 c) for s and dp, and a 4 x hd/16 patch of its output tile
// (rows 4 ty + a, columns tx + 16 c) for dv/dk or dq.
//
// What bounds it.  Per live (query, key) pair the function needs 10 hd
// f32 multiply-adds' worth of work at least (s, dp, dv, dk, dq: 2 hd FLOP
// each); this design recomputes s and dp in the dq launch, 14 hd in all,
// against reading q, k, v, O, dO once and writing dq, dk, dv: operations
// bind.  Everything runs on the CUDA cores (67 TFLOP/s of f32); the two
// products whose operands are exact in bf16 (q k^T and dO v^T) could move
// to the tensor cores in a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* lse, const void* dout, void* dq, void* dk, void* dv,
           void* delta, int B, int S, int H, int Kh, int k_len, int causal,
           int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  cudaError_t err = set_smem(flash_bwd_dkdv_kernel<T, HD>, smem);
  if (err == cudaSuccess) err = set_smem(flash_bwd_dq_kernel<T, HD>, smem);
  if (err != cudaSuccess) return (int)err;
  const size_t rows = (size_t)B * S * H;
  const unsigned row_blocks = (unsigned)((rows * 32 + THREADS - 1) / THREADS);
  flash_bwd_delta_kernel<T, HD><<<row_blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<float*>(delta), rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int n_t = (S + BQ - 1) / BQ;
  flash_bwd_dkdv_kernel<T, HD><<<dim3(Kh, n_t, B), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), S, H, Kh, k_len, causal,
      window, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<T, HD><<<dim3(H, n_t, B), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), S, H, Kh, k_len, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v,
              const void* o, const void* lse, const void* dout, void* dq,
              void* dk, void* dv, void* delta, int B, int S, int H, int Kh,
              int k_len, int causal, int window, float scale,
              cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, S, H, Kh, k_len, causal, window, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, S, H, Kh, k_len, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, S, H, Kh, k_len, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, S, H, Kh, k_len, causal, window, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, for q, k, v, o, dout, dq, dk and dv alike;
// hd: 16, 32, 64 or 128; q, o, dout, dq (B, S, H, hd) and k, v, dk, dv
// (B, S, Kh, hd), contiguous; lse (B, S, H) float32 from the forward;
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
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, o, lse, dout, dq, dk, dv, delta, B, S, H, Kh, k_len, causal, window, scale, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, o, lse, dout, dq, dk, dv, delta, B, S, H, Kh, k_len, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
