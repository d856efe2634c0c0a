// K4 on Hopper: the RWKV-6 (WKV6) recurrence with data-dependent decay, in
// chunks of C = 32 steps, parallel over the chunks of a sequence.
//
// Replaces the Pallas TPU kernel src/repro/kernels/wkv6/kernel.py, function
// wkv6_fill (body _body), with its wrapper ops.py::wkv6, and computes the
// exact pairwise log-difference form of models/mixers._wkv_chunk: per chunk
// c with inclusive log-decay sums L and exclusive ones Lq = L - lw,
//   A[i,j] = sum_d r[i,d] k[j,d] exp(min(Lq[i,d] - L[j,d], 0))   (j < i)
//   A[i,i] = sum_d r[i,d] u[d] k[i,d]
//   y      = A v + (r * exp(Lq)) S_{c-1}
//   S_c    = exp(L[C-1]) * S_{c-1} + (k * exp(L[C-1] - L))^T v
// from S_{-1} = 0.  It also writes the final (hd, hd) state, which the
// Pallas kernel keeps in VMEM scratch: the model's prefill returns it as the
// decode cache.
//
// Mapping.  The TPU walks a head's chunks in order on one core.  Here a
// call is three CUDA launches on one stream, each ordered after the last:
//   1. increments, one block per (chunk, head, batch row): the chunk's
//      state increment dS_c = (k * exp(L[C-1] - L))^T v and its decay
//      exp(L[C-1]), into scratch;
//   2. scan, one thread per state entry (d, n) of each (head, batch row):
//      S_c = exp(L[C-1])_d S_{c-1} + dS_c walks the chunks, each entry
//      alone (the decay scales the key dimension d only), 16 chunks'
//      loads in flight, overwriting each dS_c in the scratch with the
//      chunk's incoming state S_{c-1}, and writing the last state out;
//   3. output, one block per (chunk, head, batch row): the A tile, then
//      y = [A | r * exp(Lq)] [v ; S_{c-1}] as one product of depth C + hd.
//      v and S_{c-1} wait in registers while the A tile is built, then
//      take the place of its operands in shared memory (49 KB at hd 64,
//      four blocks to an SM).
// At a batch-1 rwkv6-3b prefill of 1536 steps that is 48 x 48 = 2304
// blocks in stages 1 and 3 and 768 in stage 2, where one block per head
// walking all chunks gave 48 on the card's 132 SMs.  The A tile's 496
// entries below the diagonal take one thread each, enumerated so no lane
// idles above the diagonal, and the 32 bonus entries one lane each; it
// keeps the log-difference form, not exp(Lq) * exp(-L): under strong decay
// L runs to -1e3 and beyond over 32 steps and exp(-L) overflows f32.
// Cumulative sums run step by step, one thread per column, in
// torch.cumsum's order (see cumsum_steps).  Per-chunk operands sit in
// shared memory as f32, rows padded to 16 bytes; the products use a
// register patch per thread with vector reads of both operands.  Steps
// past S load as k = v = 0, lw = 0, so they leave the state unchanged and
// their y is not stored: any S works.
//
// What bounds it.  The recurrence needs 5 hd^2 + 6 hd f32 operations per
// step and head against hd elements each of r, k, v, lw in and of y out,
// so operations bind, on the CUDA cores.  This chunked form does more: the
// A tile's 496 x hd exps (one special-function result per lane each, 16
// a clock on an SM) and shared-memory reads of four operands per term,
// and the product's (C + hd) x C x hd multiply-adds.  It also moves the
// B * H * n_chunks * hd^2 f32 scratch of states (37.7 MB at rwkv6-3b's
// 1536-step prefill) three times: written by stage 1, read and rewritten
// by stage 2, read by stage 3.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 32;          // chunk length
constexpr int THREADS = 256;
constexpr int STRICT = C * (C - 1) / 2;   // entries of A below the diagonal

// Eight consecutive elements of one step, loaded now and widened to f32
// when stored to shared memory, so that a load can stay in flight while
// the block computes (16 bytes of bf16, 32 of f32).
template <typename T>
struct Raw8;
template <>
struct Raw8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = *reinterpret_cast<const float4*>(p);
    b = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ __forceinline__ void zero() {
    a = b = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ void store(float* p) const {
    *reinterpret_cast<float4*>(p) = a;
    *reinterpret_cast<float4*>(p + 4) = b;
  }
};
template <>
struct Raw8<__nv_bfloat16> {
  uint4 a;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    a = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void zero() { a = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ void store(float* p) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
    const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
    const float2 f2 = __bfloat1622float2(h[2]), f3 = __bfloat1622float2(h[3]);
    *reinterpret_cast<float4*>(p) = make_float4(f0.x, f0.y, f1.x, f1.y);
    *reinterpret_cast<float4*>(p + 4) = make_float4(f2.x, f2.y, f3.x, f3.y);
  }
};

// Inclusive sums over the chunk's steps of each column d of x[C][LD], in
// step order: the order of torch.cumsum on the card, which the plain version
// uses.  Under strong decay L runs to -1e3 and beyond while its differences
// Lq[i] - L[j] stay small, so two sum orders can disagree in those
// differences by more than the tolerance.  ex, if given, gets the
// exclusive sums.
template <int HD, int LD>
__device__ __forceinline__ void cumsum_steps(float* x, float* ex) {
  for (int d = threadIdx.x; d < HD; d += THREADS) {
    float col[C];
#pragma unroll
    for (int t = 0; t < C; ++t) col[t] = x[t * LD + d];
    float run = 0.f;
#pragma unroll
    for (int t = 0; t < C; ++t) {
      run += col[t];
      x[t * LD + d] = run;
      if (ex) ex[t * LD + d] = run - col[t];
    }
  }
}

// The thread's patch of out[M][N] = sum_k a[k][m] b[k][n] over k < K, with
// a[k][m] at a[k * lda + m] and b[k][n] at b[k * ldb + n] (rows of both
// 16-byte aligned): rows m0 .. m0 + TM - 1 and columns n0 .. n0 + 3, for
// N / 4 column groups x RG row groups of threads, each step's a and b
// read as one vector each.  Threads past them get active = false.
template <int M, int N>
struct Patch {
  static constexpr int CG = N / 4;
  static constexpr int RG = M < THREADS / CG ? M : THREADS / CG;
  static constexpr int TM = M / RG;
  static_assert(N % 4 == 0 && M % RG == 0 && (TM == 1 || TM == 2 ||
                                               TM == 4), "patch tiling");
  bool active;
  int m0, n0;
  float c[TM][4];
  __device__ __forceinline__ Patch() {
    active = threadIdx.x < CG * RG;
    m0 = (threadIdx.x / CG) * TM;
    n0 = (threadIdx.x % CG) * 4;
  }
  template <int K>
  __device__ __forceinline__ void run(const float* a, int lda, const float* b,
                                      int ldb) {
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) c[m][n] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < K; ++kk) {
      const float4 bv = *reinterpret_cast<const float4*>(b + kk * ldb + n0);
      float av[TM];
      const float* ak = a + kk * lda + m0;
      if constexpr (TM == 4) {
        const float4 t = *reinterpret_cast<const float4*>(ak);
        av[0] = t.x; av[1] = t.y; av[2] = t.z; av[3] = t.w;
      } else if constexpr (TM == 2) {
        const float2 t = *reinterpret_cast<const float2*>(ak);
        av[0] = t.x; av[1] = t.y;
      } else {
        av[0] = ak[0];
      }
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        c[m][0] = fmaf(av[m], bv.x, c[m][0]);
        c[m][1] = fmaf(av[m], bv.y, c[m][1]);
        c[m][2] = fmaf(av[m], bv.z, c[m][2]);
        c[m][3] = fmaf(av[m], bv.w, c[m][3]);
      }
    }
  }
};

// ---------------------------------------------------------------------------
// 1. increments: dS_c and exp(L[C-1]) of one chunk
// ---------------------------------------------------------------------------
template <int HD>
constexpr size_t delta_smem_floats() {
  return 3 * (size_t)C * (HD + 4);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) wkv6_delta_kernel(
    const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ lw, float* __restrict__ states,
    float* __restrict__ decay, int S, int H) {
  constexpr int RS = HD + 4;   // rows 16-byte aligned
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;            // [C][RS] k, then k * exp(L[C-1] - L)
  float* Ls = Ks + C * RS;     // [C][RS] lw, then L
  float* Vs = Ls + C * RS;     // [C][RS]

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const size_t stride = (size_t)H * HD;   // between steps
  const size_t base = (size_t)b * S * stride + (size_t)h * HD;
  static_assert(C * HD / 8 <= THREADS, "one 8-element group per thread");
  if (threadIdx.x < C * HD / 8) {   // 8 elements of one step
    const int t = threadIdx.x / (HD / 8), d = (threadIdx.x % (HD / 8)) * 8;
    Raw8<T> kx, vx;
    Raw8<float> lx;
    if (c * C + t < S) {
      const size_t g = base + (size_t)(c * C + t) * stride + d;
      kx.load(k + g);
      vx.load(v + g);
      lx.load(lw + g);
    } else {
      kx.zero();
      vx.zero();
      lx.zero();
    }
    kx.store(Ks + t * RS + d);
    lx.store(Ls + t * RS + d);
    vx.store(Vs + t * RS + d);
  }
  __syncthreads();
  cumsum_steps<HD, RS>(Ls, nullptr);
  __syncthreads();
  const size_t slot = ((size_t)b * H + h) * nc + c;
  for (int e = threadIdx.x; e < C * HD; e += THREADS) {
    const int t = e / HD, d = e % HD;
    Ks[t * RS + d] *= expf(Ls[(C - 1) * RS + d] - Ls[t * RS + d]);
  }
  for (int d = threadIdx.x; d < HD; d += THREADS)
    decay[slot * HD + d] = expf(Ls[(C - 1) * RS + d]);
  __syncthreads();

  Patch<HD, HD> p;             // dS[d][n] = sum_t kd[t][d] v[t][n]
  if (!p.active) return;
  p.template run<C>(Ks, RS, Vs, RS);
  float* out = states + slot * HD * HD;
#pragma unroll
  for (int m = 0; m < Patch<HD, HD>::TM; ++m)
    *reinterpret_cast<float4*>(out + (p.m0 + m) * HD + p.n0) =
        make_float4(p.c[m][0], p.c[m][1], p.c[m][2], p.c[m][3]);
}

// ---------------------------------------------------------------------------
// 2. scan over the chunk states, one thread per entry (d, n)
// ---------------------------------------------------------------------------
// Chunks whose loads a scan thread issues together: the scan waits on
// memory once per batch.
constexpr int SCAN_BATCH = 16;

template <int HD>
__global__ void __launch_bounds__(THREADS) wkv6_scan_kernel(
    float* __restrict__ states, const float* __restrict__ decay,
    float* __restrict__ state_out, int nc, int H) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= HD * HD) return;
  const int d = e / HD;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  float* slot = states + bh * nc * HD * HD + e;
  const float* dec = decay + bh * nc * HD + d;
  constexpr size_t SS = (size_t)HD * HD;   // between chunks
  float s = 0.f;
  for (int c0 = 0; c0 < nc; c0 += SCAN_BATCH) {
    // the batch's loads first, none behind a branch (a batch past the last
    // chunk rereads it); then the updates, in chunk order
    float ds[SCAN_BATCH], w[SCAN_BATCH];
#pragma unroll
    for (int i = 0; i < SCAN_BATCH; ++i) {
      const int ci = min(c0 + i, nc - 1);
      ds[i] = slot[ci * SS];
      w[i] = dec[ci * HD];
    }
#pragma unroll
    for (int i = 0; i < SCAN_BATCH; ++i)
      if (c0 + i < nc) {
        slot[(c0 + i) * SS] = s;
        s = w[i] * s + ds[i];
      }
  }
  state_out[bh * HD * HD + e] = s;
}

// ---------------------------------------------------------------------------
// 3. output: y = A v + (r * exp(Lq)) S_{c-1} of one chunk
// ---------------------------------------------------------------------------
// The A tile's operands [r, k, L, Lq] and then, in the same place, the
// product's right operand [v ; S_{c-1}]; then [A | r exp(Lq)]^T and u.
template <int HD>
__host__ __device__ constexpr size_t out_operands_floats() {
  return 4 * (size_t)C * (HD + 4) > (size_t)(C + HD) * (HD + 4)
             ? 4 * (size_t)C * (HD + 4) : (size_t)(C + HD) * (HD + 4);
}
template <int HD>
constexpr size_t out_smem_floats() {
  return out_operands_floats<HD>() + (size_t)(C + HD) * (C + 4) + HD;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) wkv6_out_kernel(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ lw,
    const float* __restrict__ u, const float* __restrict__ states,
    float* __restrict__ y, int S, int H) {
  constexpr int RS = HD + 4;   // rows read as float4
  constexpr int XS = C + 4;    // [A | r exp(Lq)] stored transposed: [k][i]
  constexpr int YS = HD + 4;   // [v ; S_{c-1}]: [k][n]
  // float4s of S_{c-1} per thread
  constexpr int NS = (HD * HD / 4 + THREADS - 1) / THREADS;
  static_assert(C * HD / 8 <= THREADS, "one 8-element group per thread");
  extern __shared__ __align__(16) float smem[];
  float* Rs = smem;            // [C][RS]
  float* Ks = Rs + C * RS;     // [C][RS]
  float* Ls = Ks + C * RS;     // [C][RS] lw, then L
  float* Lq = Ls + C * RS;     // [C][RS]
  // once the A tile is built, in the same place: [C + HD][YS], v then
  // S_{c-1}
  float* Yb = smem;
  // [C + HD][XS]: A^T, then (r exp(Lq))^T
  float* Xt = smem + out_operands_floats<HD>();
  float* us = Xt + (C + HD) * XS;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const size_t stride = (size_t)H * HD;
  const size_t base = (size_t)b * S * stride + (size_t)h * HD;
  // 8 elements of one step each; v and S_{c-1} wait in registers until
  // the A tile is built
  const int t = threadIdx.x / (HD / 8), d8 = (threadIdx.x % (HD / 8)) * 8;
  const bool loader = threadIdx.x < C * HD / 8;
  Raw8<T> vx;
  {
    Raw8<T> rx, kx;
    Raw8<float> lx;
    if (loader && c * C + t < S) {
      const size_t g = base + (size_t)(c * C + t) * stride + d8;
      rx.load(r + g);
      kx.load(k + g);
      vx.load(v + g);
      lx.load(lw + g);
    } else {
      rx.zero();
      kx.zero();
      vx.zero();
      lx.zero();
    }
    if (loader) {
      rx.store(Rs + t * RS + d8);
      kx.store(Ks + t * RS + d8);
      lx.store(Ls + t * RS + d8);
    }
  }
  const float4* s_in = reinterpret_cast<const float4*>(
      states + (((size_t)b * H + h) * nc + c) * HD * HD);
  float4 sx[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    if (e < HD * HD / 4) sx[i] = s_in[e];
  }
  for (int d = threadIdx.x; d < HD; d += THREADS) us[d] = u[(size_t)h * HD + d];
  __syncthreads();
  cumsum_steps<HD, RS>(Ls, Lq);
  __syncthreads();

  // A^T: entry e of the strict lower triangle is row i, column j < i
  for (int e = threadIdx.x; e < STRICT; e += THREADS) {
    int i = (int)((1.f + sqrtf(8.f * e + 1.f)) * 0.5f);
    while (i * (i - 1) / 2 > e) --i;
    while (i * (i + 1) / 2 <= e) ++i;
    const int j = e - i * (i - 1) / 2;
    const float* ri = Rs + i * RS;
    const float* kj = Ks + j * RS;
    const float* lqi = Lq + i * RS;
    const float* lj = Ls + j * RS;
    // The exponent is <= 0, where __expf (ex2.approx) errs by under 6e-6
    // relative, about a hundredth of the tolerance.
    float a = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 rv = *reinterpret_cast<const float4*>(ri + d);
      const float4 kv = *reinterpret_cast<const float4*>(kj + d);
      const float4 qv = *reinterpret_cast<const float4*>(lqi + d);
      const float4 lv = *reinterpret_cast<const float4*>(lj + d);
      a += rv.x * kv.x * __expf(fminf(qv.x - lv.x, 0.f));
      a += rv.y * kv.y * __expf(fminf(qv.y - lv.y, 0.f));
      a += rv.z * kv.z * __expf(fminf(qv.z - lv.z, 0.f));
      a += rv.w * kv.w * __expf(fminf(qv.w - lv.w, 0.f));
    }
    Xt[j * XS + i] = a;
  }
  for (int i = threadIdx.x; i < C; i += THREADS) {   // the bonus r u k
    const float* ri = Rs + i * RS;
    const float* ki = Ks + i * RS;
    float a = 0.f;
    for (int d = 0; d < HD; ++d) a += ri[d] * us[d] * ki[d];
    Xt[i * XS + i] = a;
  }
  for (int e = threadIdx.x; e < C * C; e += THREADS) {
    const int j = e / C, i = e % C;
    if (j > i) Xt[j * XS + i] = 0.f;
  }
  for (int e = threadIdx.x; e < C * HD; e += THREADS) {
    const int d = e / C, i = e % C;
    Xt[(C + d) * XS + i] = Rs[i * RS + d] * expf(Lq[i * RS + d]);
  }
  __syncthreads();             // r, k, L and Lq are dead: [v ; S_{c-1}]
  if (loader) vx.store(Yb + t * YS + d8);
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    if (e < HD * HD / 4)
      *reinterpret_cast<float4*>(Yb + (C + e / (HD / 4)) * YS +
                                 (e % (HD / 4)) * 4) = sx[i];
  }
  __syncthreads();

  Patch<C, HD> p;
  if (!p.active) return;
  p.template run<C + HD>(Xt, XS, Yb, YS);
#pragma unroll
  for (int m = 0; m < Patch<C, HD>::TM; ++m) {
    const int pos = c * C + p.m0 + m;
    if (pos < S)
      *reinterpret_cast<float4*>(y + base + (size_t)pos * stride + p.n0) =
          make_float4(p.c[m][0], p.c[m][1], p.c[m][2], p.c[m][3]);
  }
}

// ---------------------------------------------------------------------------
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const void* lw,
           const void* u, void* y, void* state, void* states, void* decay,
           int B, int S, int H, cudaStream_t stream) {
  const int nc = (S + C - 1) / C;
  const size_t smem1 = delta_smem_floats<HD>() * sizeof(float);
  const size_t smem3 = out_smem_floats<HD>() * sizeof(float);
  cudaError_t err = set_smem(wkv6_delta_kernel<T, HD>, smem1);
  if (err == cudaSuccess) err = set_smem(wkv6_out_kernel<T, HD>, smem3);
  if (err != cudaSuccess) return (int)err;
  const dim3 chunks(nc, H, B);
  if (nc > 0) {
    wkv6_delta_kernel<T, HD><<<chunks, THREADS, smem1, stream>>>(
        static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(lw), static_cast<float*>(states),
        static_cast<float*>(decay), S, H);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const dim3 entries((HD * HD + THREADS - 1) / THREADS, H, B);
  wkv6_scan_kernel<HD><<<entries, THREADS, 0, stream>>>(
      static_cast<float*>(states), static_cast<const float*>(decay),
      static_cast<float*>(state), nc, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (nc > 0) {
    wkv6_out_kernel<T, HD><<<chunks, THREADS, smem3, stream>>>(
        static_cast<const T*>(r), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(lw),
        static_cast<const float*>(u), static_cast<const float*>(states),
        static_cast<float*>(y), S, H);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename T>
int launch_hd(int hd, const void* r, const void* k, const void* v,
              const void* lw, const void* u, void* y, void* state,
              void* states, void* decay, int B, int S, int H,
              cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(r, k, v, lw, u, y, state, states, decay, B, S, H, s);
    case 32: return launch<T, 32>(r, k, v, lw, u, y, state, states, decay, B, S, H, s);
    case 64: return launch<T, 64>(r, k, v, lw, u, y, state, states, decay, B, S, H, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (r, k and v); lw float32, all four
// (B, S, H, hd) contiguous; u (H, hd) float32; y (B, S, H, hd) float32;
// state (B, H, hd, hd) float32, written at the end.  Scratch, float32:
// states (B, H, ceil(S / 32), hd, hd) and decay (B, H, ceil(S / 32), hd).
// hd: 16, 32 or 64.  Three CUDA launches on `stream` (two when S = 0).
// Returns the CUDA error code of the first launch that fails (0 on
// success).
int wkv6_fill_launch(int dtype, int hd, const void* r, const void* k,
                     const void* v, const void* lw, const void* u, void* y,
                     void* state, void* states, void* decay, int B, int S,
                     int H, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(hd, r, k, v, lw, u, y, state, states, decay, B, S, H, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, r, k, v, lw, u, y, state, states, decay, B, S, H, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
