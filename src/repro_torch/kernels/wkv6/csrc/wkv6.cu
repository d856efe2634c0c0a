// K4 on Hopper: the RWKV-6 (WKV6) recurrence with data-dependent decay, in
// chunks of C = 32 steps.
//
// Replaces the Pallas TPU kernel src/repro/kernels/wkv6/kernel.py, function
// wkv6_fill (body _body), with its wrapper ops.py::wkv6, and computes the
// exact pairwise log-difference form of models/mixers._wkv_chunk: per chunk
// with inclusive log-decay sums L and exclusive ones Lq = L - lw,
//   A[i,j] = sum_d r[i,d] k[j,d] exp(min(Lq[i,d] - L[j,d], 0))   (j < i)
//   A[i,i] = sum_d r[i,d] u[d] k[i,d]
//   y      = A v + (r * exp(Lq)) state
//   state  = exp(L[C-1]) * state + (k * exp(L[C-1] - L))^T v
// It also writes the final (hd, hd) state, which the Pallas kernel keeps
// in VMEM scratch: the model's prefill returns it as the decode cache.
//
// Mapping.  One thread block of 256 threads per (batch row, head); a loop
// over chunks inside the block takes the place of the TPU's sequential
// sequence-block axis, and the f32 state lives in shared memory for the
// whole sequence.  Per chunk, r/k/v/lw go to shared memory as f32 (rows
// padded to hd + 1 floats, so threads reading neighbouring steps of one
// column hit distinct banks); hd threads run the 32-step cumulative sums;
// the 32 x 32 tile A is built pair by pair, never the (C, C, hd) tensor of
// pairwise decays that the Pallas body holds in VMEM (256 KiB at hd = 64,
// more than a block's shared memory).  Keeping the log-difference form,
// not exp(Lq) * exp(-L), matters: under strong decay L reaches about -236
// over 32 steps and exp(-L) overflows f32.  Steps past S load as k = 0,
// lw = 0, so they leave the state unchanged and their y is not stored: any
// S works.
//
// What bounds it.  The recurrence needs 5 hd^2 + 6 hd f32 operations per
// step and head (0.67 M per 32 steps at hd 64; this chunked form does
// about 0.9 M, a third of them the exps and products of A) against 32 x hd
// elements each of r, k, v, lw in and of y out, so operations bind, on the
// CUDA cores.  At a batch-1 prefill, rwkv6-3b's 48 heads give 48 blocks on
// 132 SMs: most of the card idles.  Splitting a head's sequence across
// blocks (a chunked scan with a second pass for the carried state) is
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 32;          // chunk length
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int HD>
constexpr size_t smem_floats() {
  return (size_t)HD * HD + 5 * (size_t)C * (HD + 1) + (size_t)C * (C + 1) + HD;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) wkv6_kernel(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ lw,
    const float* __restrict__ u, float* __restrict__ y,
    float* __restrict__ state_out, int S, int H) {
  constexpr int RS = HD + 1;   // padded row of the per-chunk arrays
  extern __shared__ __align__(16) float smem[];
  float* St = smem;            // [HD][HD] state, [k-dim][v-dim]
  float* Rs = St + HD * HD;    // [C][RS] r, then r * exp(Lq)
  float* Ks = Rs + C * RS;     // [C][RS] k, then k * exp(L[C-1] - L)
  float* Vs = Ks + C * RS;     // [C][RS] v
  float* Ls = Vs + C * RS;     // [C][RS] lw, then L (inclusive)
  float* Lq = Ls + C * RS;     // [C][RS] Lq = L - lw
  float* As = Lq + C * RS;     // [C][C + 1]
  float* us = As + C * (C + 1);

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const size_t stride = (size_t)H * HD;   // between steps
  const size_t base = (size_t)b * S * stride + (size_t)h * HD;

  for (int e = tid; e < HD * HD; e += THREADS) St[e] = 0.f;
  for (int d = tid; d < HD; d += THREADS) us[d] = u[(size_t)h * HD + d];

  for (int c0 = 0; c0 < S; c0 += C) {
    __syncthreads();   // the previous chunk's readers are done
    for (int e = tid; e < C * HD; e += THREADS) {
      const int t = e / HD, d = e % HD;
      const int pos = c0 + t;
      const bool in = pos < S;
      const size_t g = base + (size_t)pos * stride + d;
      Rs[t * RS + d] = in ? to_f32(r[g]) : 0.f;
      Ks[t * RS + d] = in ? to_f32(k[g]) : 0.f;
      Vs[t * RS + d] = in ? to_f32(v[g]) : 0.f;
      Ls[t * RS + d] = in ? lw[g] : 0.f;
    }
    __syncthreads();
    for (int d = tid; d < HD; d += THREADS) {
      float run = 0.f;
      for (int t = 0; t < C; ++t) {
        const float l = Ls[t * RS + d];
        run += l;
        Ls[t * RS + d] = run;
        Lq[t * RS + d] = run - l;
      }
    }
    __syncthreads();

    for (int e = tid; e < C * C; e += THREADS) {
      const int i = e / C, j = e % C;
      float a = 0.f;
      if (j < i) {
        for (int d = 0; d < HD; ++d)
          a += Rs[i * RS + d] * Ks[j * RS + d] *
               expf(fminf(Lq[i * RS + d] - Ls[j * RS + d], 0.f));
      } else if (j == i) {
        for (int d = 0; d < HD; ++d)
          a += Rs[i * RS + d] * us[d] * Ks[i * RS + d];
      }
      As[i * (C + 1) + j] = a;
    }
    __syncthreads();
    for (int e = tid; e < C * HD; e += THREADS) {
      const int t = e / HD, d = e % HD;
      const float lc = Ls[(C - 1) * RS + d];
      Rs[t * RS + d] *= expf(Lq[t * RS + d]);
      Ks[t * RS + d] *= expf(lc - Ls[t * RS + d]);
    }
    __syncthreads();

    for (int e = tid; e < C * HD; e += THREADS) {
      const int i = e / HD, vc = e % HD;
      float intra = 0.f, inter = 0.f;
      for (int j = 0; j < C; ++j) intra += As[i * (C + 1) + j] * Vs[j * RS + vc];
      for (int d = 0; d < HD; ++d) inter += Rs[i * RS + d] * St[d * HD + vc];
      if (c0 + i < S) y[base + (size_t)(c0 + i) * stride + vc] = intra + inter;
    }
    __syncthreads();
    for (int e = tid; e < HD * HD; e += THREADS) {
      const int d = e / HD, vc = e % HD;
      float inj = 0.f;
      for (int j = 0; j < C; ++j) inj += Ks[j * RS + d] * Vs[j * RS + vc];
      St[e] = expf(Ls[(C - 1) * RS + d]) * St[e] + inj;
    }
  }
  __syncthreads();
  float* so = state_out + (size_t)blockIdx.x * HD * HD;
  for (int e = tid; e < HD * HD; e += THREADS) so[e] = St[e];
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const void* lw,
           const void* u, void* y, void* state, int B, int S, int H,
           cudaStream_t stream) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  wkv6_kernel<T, HD><<<B * H, THREADS, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(lw),
      static_cast<const float*>(u), static_cast<float*>(y),
      static_cast<float*>(state), S, H);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* r, const void* k, const void* v,
              const void* lw, const void* u, void* y, void* state, int B,
              int S, int H, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(r, k, v, lw, u, y, state, B, S, H, s);
    case 32: return launch<T, 32>(r, k, v, lw, u, y, state, B, S, H, s);
    case 64: return launch<T, 64>(r, k, v, lw, u, y, state, B, S, H, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (r, k and v); lw float32, all four
// (B, S, H, hd) contiguous; u (H, hd) float32; y (B, S, H, hd) float32;
// state (B, H, hd, hd) float32, written at the end.  hd: 16, 32 or 64.
// Returns the CUDA error code of the launch (0 on success).
int wkv6_fill_launch(int dtype, int hd, const void* r, const void* k,
                     const void* v, const void* lw, const void* u, void* y,
                     void* state, int B, int S, int H, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_hd<float>(hd, r, k, v, lw, u, y, state, B, S, H, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, r, k, v, lw, u, y, state, B, S, H, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
