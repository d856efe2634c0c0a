// K3 on Hopper: blockwise online-softmax attention (the forward pass of
// flash attention).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attn/kernel.py,
// function flash_fill (body _body), with its wrapper ops.py::flash, and
// computes what they compute: softmax(q k^T * scale) v per (batch, head)
// under causal, sliding-window and key-length masks, with the scores, the
// running row maximum, the row sum, p and the accumulator in f32, and the
// output in q's type.  Masked scores take the finite sentinel -1e30 (never
// -inf): a row whose first live tile is fully masked then sees
// exp(s - m) = 1 there, and the first tile with a live key rescales that
// by exp(-1e30 - m) = 0.  The sum is clamped at 1e-30 before the divide.
//
// Mapping.  One thread block of 256 threads per (64-row q-tile, head,
// batch row); a loop over 64-row k-tiles inside the block takes the place
// of the TPU's sequential ("arbitrary") k grid axis, and k-tiles that lie
// wholly outside the causal or window band, or at or past k_len, are
// skipped, as _body's pl.when(live) skips them.  Grouped-query attention
// reads key/value head h / (H / Kh) directly (the Pallas wrapper repeats
// k and v in device memory).  Rows and keys past S are loaded as zeros,
// masked and not stored, so any S works (the Pallas kernel needs S to be
// a multiple of its block).  In shared memory, as f32: the q- and k-tiles
// transposed ([d][row], so a thread reads four rows as one float4), the
// v-tile, the 64 x 64 score/p tile and the per-row max, sum and rescale.
// Scores: each thread computes a 4 x 4 patch over hd.  Softmax: one warp
// per 8 rows, shuffles for the row max and sum.  p v: each thread owns one
// output column d and BQ * HD / 256 rows, accumulators in registers.
//
// What bounds it.  The work is 2 * S_live * hd multiply-adds per query row
// (S_live its unmasked keys; q . k and p v) against one read of q, k, v
// and one write of o: far above the card's bytes-to-operations balance,
// so the arithmetic rate binds.  This first
// kernel runs on the CUDA cores in f32 (67 TFLOP/s at most) and reads its
// tiles with plain loads, where a fast one runs bf16 wgmma on the tensor
// cores (989 TFLOP/s) fed by TMA; that redesign is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // q-tile rows
constexpr int BK = 64;       // k-tile rows
constexpr int PAD = 4;       // row padding of the transposed tiles (floats)
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int HD>
constexpr size_t smem_floats() {
  return (size_t)HD * (BQ + PAD) + (size_t)HD * (BK + PAD) +
         (size_t)BK * HD + (size_t)BQ * (BK + PAD) + 3 * BQ;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int S, int H, int Kh,
    int k_len, int causal, int window, float scale) {
  static_assert(THREADS % HD == 0 && BQ % (THREADS / HD) == 0, "tiling");
  constexpr int QS = BQ + PAD;
  constexpr int KS = BK + PAD;
  constexpr int NRG = THREADS / HD;  // row groups of the p v stage
  constexpr int RPT = BQ / NRG;      // output rows per thread
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                  // [HD][QS]
  float* Kt = Qt + HD * QS;          // [HD][KS]
  float* Vs = Kt + HD * KS;          // [BK][HD]
  float* Ps = Vs + BK * HD;          // [BQ][KS]
  float* row_m = Ps + BQ * KS;
  float* row_l = row_m + BQ;
  float* row_a = row_l + BQ;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / Kh);
  const size_t q_stride = (size_t)H * HD;    // between positions
  const size_t kv_stride = (size_t)Kh * HD;
  const T* qb = q + (size_t)b * S * q_stride + (size_t)h * HD;
  const T* kb = k + (size_t)b * S * kv_stride + (size_t)kh * HD;
  const T* vb = v + (size_t)b * S * kv_stride + (size_t)kh * HD;
  T* ob = o + (size_t)b * S * q_stride + (size_t)h * HD;

  for (int e = tid; e < BQ * HD; e += THREADS) {
    const int i = e % BQ, d = e / BQ;
    const int pos = q0 + i;
    Qt[d * QS + i] = pos < S ? to_f32(qb[(size_t)pos * q_stride + d]) : 0.f;
  }
  if (tid < BQ) {
    row_m[tid] = NEG_INF;
    row_l[tid] = 0.f;
  }
  const int od = tid % HD;
  const int org = tid / HD;
  float acc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = 0.f;

  const int tx = tid % 16;   // score patch: columns 4 tx .. 4 tx + 3
  const int ty = tid / 16;   //              rows    4 ty .. 4 ty + 3
  const int warp = tid / 32, lane = tid % 32;
  const int n_k = (S + BK - 1) / BK;

  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    bool live = k0 < k_len;
    if (causal) live = live && k0 <= q0 + BQ - 1;
    if (window > 0) live = live && k0 + BK - 1 > q0 - window;
    if (!live) continue;   // the same for every thread of the block
    __syncthreads();       // the previous tile's readers are done
    for (int e = tid; e < BK * HD; e += THREADS) {
      const int j = e % BK, d = e / BK;
      const int pos = k0 + j;
      Kt[d * KS + j] = pos < S ? to_f32(kb[(size_t)pos * kv_stride + d]) : 0.f;
    }
    for (int e = tid; e < BK * HD; e += THREADS) {
      const int j = e / HD, d = e % HD;
      const int pos = k0 + j;
      Vs[j * HD + d] = pos < S ? to_f32(vb[(size_t)pos * kv_stride + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qt[d * QS + 4 * ty]);
      const float4 kc = *reinterpret_cast<const float4*>(&Kt[d * KS + 4 * tx]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {kc.x, kc.y, kc.z, kc.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = fmaf(qv[a], kv[c], s[a][c]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qpos = q0 + 4 * ty + a;
      float out[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + 4 * tx + c;
        bool ok = kpos < k_len;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        out[c] = ok ? s[a][c] * scale : NEG_INF;
      }
      *reinterpret_cast<float4*>(&Ps[(4 * ty + a) * KS + 4 * tx]) =
          make_float4(out[0], out[1], out[2], out[3]);
    }
    __syncthreads();

    for (int rr = 0; rr < BQ / (THREADS / 32); ++rr) {
      const int i = warp * (BQ / (THREADS / 32)) + rr;
      float* row = Ps + i * KS;
      const float x0 = row[lane], x1 = row[lane + 32];
      const float m_old = row_m[i];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      const float sum = warp_sum(p0 + p1);
      row[lane] = p0;
      row[lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        row_a[i] = alpha;
        row_l[i] = row_l[i] * alpha + sum;
        row_m[i] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < RPT; ++r) acc[r] *= row_a[org + NRG * r];
    for (int j = 0; j < BK; j += 4) {
      const float v0 = Vs[(j + 0) * HD + od], v1 = Vs[(j + 1) * HD + od];
      const float v2 = Vs[(j + 2) * HD + od], v3 = Vs[(j + 3) * HD + od];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float4 p =
            *reinterpret_cast<const float4*>(&Ps[(org + NRG * r) * KS + j]);
        acc[r] = fmaf(p.x, v0, acc[r]);
        acc[r] = fmaf(p.y, v1, acc[r]);
        acc[r] = fmaf(p.z, v2, acc[r]);
        acc[r] = fmaf(p.w, v3, acc[r]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int i = org + NRG * r;
    const int pos = q0 + i;
    if (pos < S)
      store(&ob[(size_t)pos * q_stride + od], acc[r] / fmaxf(row_l[i], 1e-30f));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int Kh, int k_len, int causal, int window,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, Kh, k_len, causal,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o,
              int B, int S, int H, int Kh, int k_len, int causal, int window,
              float scale, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, H, Kh, k_len, causal, window, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, Kh, k_len, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, Kh, k_len, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, Kh, k_len, causal, window, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (q, k, v and o alike); hd: 16, 32, 64 or
// 128; q/o (B, S, H, hd) and k/v (B, S, Kh, hd), contiguous; k_len <= S
// keys are live; window <= 0: no window.  Returns the CUDA error code of
// the launch (0 on success).
int flash_fill_launch(int dtype, int hd, const void* q, const void* k,
                      const void* v, void* o, int B, int S, int H, int Kh,
                      int k_len, int causal, int window, float scale,
                      void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (Kh <= 0 || H % Kh) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, o, B, S, H, Kh, k_len, causal, window, scale, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, o, B, S, H, Kh, k_len, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
