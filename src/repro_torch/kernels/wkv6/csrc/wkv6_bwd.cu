// K4's backward on Hopper: the gradients of the chunked RWKV-6 (WKV6)
// recurrence with respect to r, k, v, the log-decays lw and the bonus u,
// from a zero initial state.
//
// The TPU side has no Pallas kernel for this: the JAX model path
// differentiates its chunk scan (src/repro/models/mixers.py:411-416, the
// chunk body _wkv_chunk under jax.checkpoint) by AD.  This file computes
// the gradient of the function K4's forward (csrc/wkv6.cu) and
// kernel.py::wkv6_plain compute, chunk by chunk (C = 32 steps; L the
// inclusive and Lq the exclusive cumulative log-decays, Lc = L[C-1],
// S_{c-1} the chunk's incoming state, G_c the gradient of its outgoing
// state):
//   dA[i,j]  = dy[i] . v[j]                                   (j <= i)
//   dv[j]    = sum_{i>=j} A[i,j] dy[i] + (k * exp(Lc - L))[j] G_c
//   dR~      = dy S_{c-1}^T,  R~ = r * exp(Lq)
//   dK~      = v G_c^T,       K~ = k * exp(Lc - L)
//   dr[i,d]  = sum_{j<i} dA[i,j] k[j,d] W[i,j,d] + dA[i,i] u[d] k[i,d]
//              + dR~[i,d] exp(Lq[i,d])
//   dk[j,d]  = sum_{i>j} dA[i,j] r[i,d] W[i,j,d] + dA[j,j] u[d] r[j,d]
//              + dK~[j,d] exp(Lc[d] - L[j,d])
//   du[d]    = sum over batch rows and steps of dA[i,i] r[i,d] k[i,d]
// with W[i,j,d] = exp(min(Lq[i,d] - L[j,d], 0)).  The log-decays take the
// gradients of L and Lq: from W (dA r k W where Lq[i,d] - L[j,d] <= 0, the
// entries where torch's clamp passes its gradient; JAX's jnp.minimum
// passes half at a tie, on the adjacent entries where the difference is 0
// up to rounding, and there the two paths cancel in the sum below), from
// R~ (dR~ R~ into Lq), from K~ (dK~ K~ out of L, into Lc) and from the
// decay of the state (exp(Lc) sum_n G_c S_{c-1} into Lc); then
// dlw[t] = sum_{s>=t} (dL[s] + dLq[s]) - dLq[t], a reverse cumulative sum
// within the chunk.  The state gradients run backwards over the chunks:
// G_{c-1} = exp(Lc_c) * G_c + R~_c^T dy_c, from the final state's
// gradient (zero when only y is used).
//
// Mapping: four launches on one stream, the forward's shape in reverse.
//   1. increments, one block per (chunk, head, batch row): R~^T dy and
//      exp(Lc) into scratch;
//   2. reverse scan, one thread per state entry (d, n) of each (head,
//      batch row), overwriting each increment with G_c;
//   3. gradients, one block per (chunk, head, batch row): the chunk's
//      operands, its incoming state S_{c-1} (the forward's scratch, which
//      the autograd Function keeps) and G_c in shared memory as f32; dA and
//      A first, one thread per (i, j); then one thread per (step, column)
//      for dr, dk, dv and the chunk's terms of dL, dLq and du; then one
//      thread per column for the reverse cumulative sum and du's partial
//      sum over the chunk's steps;
//   4. du, one thread per (head, column), summing the partials over batch
//      rows and chunks in a fixed order: no atomics, so the gradients are
//      the same bits from run to run.
// Cumulative sums run step by step in the forward's order.  Steps past S
// load as zeros (lw = 0: state-neutral), get no store, and add nothing to
// a real step's gradient except through Lc, as in the padded plain version.
//
// What bounds it.  Per step and head the gradient needs a few times the
// forward's 5 hd^2 + 6 hd f32 operations against hd elements each of r, k,
// v, lw, dy in and of dr, dk, dv, dlw out: operations bind, on the CUDA
// cores.  This chunked form also reads the (hd, hd) incoming state and
// writes and reads the state gradient of every chunk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 32;          // chunk length
constexpr int THREADS = 256;
constexpr int AS = C + 1;      // row stride of the A / dA tiles (floats)

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

// The chunk's C steps of one head of a (B, S, H, HD) tensor as f32 into
// dst[C][HD + 1]; steps past S are zeros.
template <typename T, int HD>
__device__ __forceinline__ void load_chunk(float* dst, const T* src,
                                           size_t base, size_t stride,
                                           int t0, int S) {
  constexpr int RS = HD + 1;
  for (int e = threadIdx.x; e < C * HD; e += THREADS) {
    const int t = e / HD, d = e % HD;
    dst[t * RS + d] = t0 + t < S
                          ? to_f32(src[base + (size_t)(t0 + t) * stride + d])
                          : 0.f;
  }
}

// Inclusive cumulative sums over the steps of each column of x[C][HD + 1]
// in step order (K4's forward order); ex gets the exclusive ones.
template <int HD>
__device__ __forceinline__ void cumsum_steps(float* x, float* ex) {
  constexpr int RS = HD + 1;
  for (int d = threadIdx.x; d < HD; d += THREADS) {
    float run = 0.f;
    for (int t = 0; t < C; ++t) {
      const float w = x[t * RS + d];
      run += w;
      x[t * RS + d] = run;
      if (ex) ex[t * RS + d] = run - w;
    }
  }
}

// ---------------------------------------------------------------------------
// 1. increments: R~^T dy and exp(Lc) of one chunk
// ---------------------------------------------------------------------------
template <int HD>
constexpr size_t inc_smem_floats() {
  return 3 * (size_t)C * (HD + 1);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) wkv6_bwd_inc_kernel(
    const T* __restrict__ r, const float* __restrict__ lw,
    const float* __restrict__ dy, float* __restrict__ gstates,
    float* __restrict__ decay, int S, int H) {
  constexpr int RS = HD + 1;
  extern __shared__ float smem[];
  float* Rs = smem;              // r, then r * exp(Lq)
  float* Ls = Rs + C * RS;       // lw, then L
  float* Lq = Ls + C * RS;       // exclusive sums, then dy
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const size_t stride = (size_t)H * HD;
  const size_t base = (size_t)b * S * stride + (size_t)h * HD;
  load_chunk<T, HD>(Rs, r, base, stride, c * C, S);
  load_chunk<float, HD>(Ls, lw, base, stride, c * C, S);
  __syncthreads();
  cumsum_steps<HD>(Ls, Lq);
  __syncthreads();
  for (int e = threadIdx.x; e < C * HD; e += THREADS) {
    const int t = e / HD, d = e % HD;
    Rs[t * RS + d] *= expf(Lq[t * RS + d]);
  }
  const size_t slot = ((size_t)b * H + h) * nc + c;
  for (int d = threadIdx.x; d < HD; d += THREADS)
    decay[slot * HD + d] = expf(Ls[(C - 1) * RS + d]);
  __syncthreads();
  float* Dy = Lq;
  load_chunk<float, HD>(Dy, dy, base, stride, c * C, S);
  __syncthreads();
  float* out = gstates + slot * HD * HD;
  for (int e = threadIdx.x; e < HD * HD; e += THREADS) {
    const int d = e / HD, n = e % HD;
    float acc = 0.f;
#pragma unroll 8
    for (int i = 0; i < C; ++i)
      acc = fmaf(Rs[i * RS + d], Dy[i * RS + n], acc);
    out[e] = acc;
  }
}

// ---------------------------------------------------------------------------
// 2. reverse scan: each increment becomes G_c, the gradient of chunk c's
//    outgoing state
// ---------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(THREADS) wkv6_bwd_scan_kernel(
    float* __restrict__ gstates, const float* __restrict__ decay,
    const float* __restrict__ dstate, int nc, int H) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= HD * HD) return;
  const int d = e / HD;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  constexpr size_t SS = (size_t)HD * HD;
  float* slot = gstates + bh * nc * SS + e;
  const float* dec = decay + bh * nc * HD + d;
  float g = dstate ? dstate[bh * SS + e] : 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const float inc = slot[c * SS];
    slot[c * SS] = g;
    g = dec[c * HD] * g + inc;
  }
}

// ---------------------------------------------------------------------------
// 3. the gradients of one chunk
// ---------------------------------------------------------------------------
// Eight [C][HD + 1] tiles (r, k, v, L, Lq, dy, R~, K~), the incoming state
// and G_c ([HD][HD + 1] each), A and dA ([C][C + 1] each) and u.
template <int HD>
constexpr size_t grad_smem_floats() {
  return 8 * (size_t)C * (HD + 1) + 2 * (size_t)HD * (HD + 1) +
         2 * (size_t)C * AS + HD;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) wkv6_bwd_grad_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ lw, const float* __restrict__ u,
    const float* __restrict__ dy, const float* __restrict__ states,
    const float* __restrict__ gstates, T* __restrict__ dr,
    T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dlw,
    float* __restrict__ du_part, int S, int H) {
  constexpr int RS = HD + 1;
  constexpr int PER = (C * HD + THREADS - 1) / THREADS;  // (i, d)s a thread
  extern __shared__ float smem[];
  float* Rs = smem;              // [C][RS] r;  later dL + dLq
  float* Ks = Rs + C * RS;       // [C][RS] k;  later dLq
  float* Vs = Ks + C * RS;       // [C][RS] v;  later dK~ K~
  float* Ls = Vs + C * RS;       // [C][RS] lw, then L
  float* Lq = Ls + C * RS;       // [C][RS]
  float* Dy = Lq + C * RS;       // [C][RS] dy; later dA[i,i] r k
  float* Rt = Dy + C * RS;       // [C][RS] r * exp(Lq)
  float* Kt = Rt + C * RS;       // [C][RS] k * exp(Lc - L)
  float* Ss = Kt + C * RS;       // [HD][RS] S_{c-1}
  float* Gs = Ss + HD * RS;      // [HD][RS] G_c
  float* As = Gs + HD * RS;      // [C][AS] A (lower triangle and diagonal)
  float* dAs = As + C * AS;      // [C][AS] dA (j <= i)
  float* us = dAs + C * AS;      // [HD]

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int t0 = c * C;
  const size_t stride = (size_t)H * HD;
  const size_t base = (size_t)b * S * stride + (size_t)h * HD;
  const size_t slot = ((size_t)b * H + h) * nc + c;
  load_chunk<T, HD>(Rs, r, base, stride, t0, S);
  load_chunk<T, HD>(Ks, k, base, stride, t0, S);
  load_chunk<T, HD>(Vs, v, base, stride, t0, S);
  load_chunk<float, HD>(Ls, lw, base, stride, t0, S);
  load_chunk<float, HD>(Dy, dy, base, stride, t0, S);
  for (int e = threadIdx.x; e < HD * HD; e += THREADS) {
    const int d = e / HD, n = e % HD;
    Ss[d * RS + n] = states[slot * HD * HD + e];
    Gs[d * RS + n] = gstates[slot * HD * HD + e];
  }
  for (int d = threadIdx.x; d < HD; d += THREADS) us[d] = u[(size_t)h * HD + d];
  __syncthreads();
  cumsum_steps<HD>(Ls, Lq);
  __syncthreads();
  const float* Lc = Ls + (C - 1) * RS;
  for (int e = threadIdx.x; e < C * HD; e += THREADS) {
    const int t = e / HD, d = e % HD;
    Rt[t * RS + d] = Rs[t * RS + d] * expf(Lq[t * RS + d]);
    Kt[t * RS + d] = Ks[t * RS + d] * expf(Lc[d] - Ls[t * RS + d]);
  }
  // dA[i][j] = dy[i] . v[j] (j <= i);  A[i][j] (j < i) and A[i][i]
  for (int e = threadIdx.x; e < C * C; e += THREADS) {
    const int i = e / C, j = e % C;
    float da = 0.f, a = 0.f;
    if (j <= i) {
      for (int n = 0; n < HD; ++n)
        da = fmaf(Dy[i * RS + n], Vs[j * RS + n], da);
      if (j < i) {
        for (int d = 0; d < HD; ++d)
          a += Rs[i * RS + d] * Ks[j * RS + d] *
               expf(fminf(Lq[i * RS + d] - Ls[j * RS + d], 0.f));
      } else {
        for (int d = 0; d < HD; ++d)
          a += Rs[i * RS + d] * us[d] * Ks[i * RS + d];
      }
    }
    dAs[i * AS + j] = da;
    As[i * AS + j] = a;
  }
  __syncthreads();

  // one thread per (step i, column d)
  float x_dl[PER], x_dlq[PER], x_t[PER], x_u[PER];
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    const int e = threadIdx.x + m * THREADS;
    x_dl[m] = x_dlq[m] = x_t[m] = x_u[m] = 0.f;
    if (e >= C * HD) continue;
    const int i = e / HD, d = e % HD;
    const float ri = Rs[i * RS + d], ki = Ks[i * RS + d];
    const float lqi = Lq[i * RS + d], li = Ls[i * RS + d];
    float drt = 0.f, dkt = 0.f, dv_ = 0.f;
    // dR~[i,d] = dy[i] . S[d];  dK~[i,d] = v[i] . G[d]
    for (int n = 0; n < HD; ++n) {
      drt = fmaf(Dy[i * RS + n], Ss[d * RS + n], drt);
      dkt = fmaf(Vs[i * RS + n], Gs[d * RS + n], dkt);
    }
    // dv[i,d] = sum_{i'>=i} A[i',i] dy[i',d] + sum_d' K~[i,d'] G[d',d]
    for (int i2 = i; i2 < C; ++i2)
      dv_ = fmaf(As[i2 * AS + i], Dy[i2 * RS + d], dv_);
    for (int d2 = 0; d2 < HD; ++d2)
      dv_ = fmaf(Kt[i * RS + d2], Gs[d2 * RS + d], dv_);
    // intra-chunk terms, i as the query (j < i) and as the key (i' > i)
    float dr_in = 0.f, dlq_in = 0.f, dk_in = 0.f, dl_in = 0.f;
    for (int j = 0; j < i; ++j) {
      const float D = lqi - Ls[j * RS + d];
      const float w = D <= 0.f ? expf(D) : 1.f;
      const float t = dAs[i * AS + j] * Ks[j * RS + d];
      dr_in = fmaf(t, w, dr_in);
      if (D <= 0.f) dlq_in = fmaf(t, w, dlq_in);
    }
    for (int i2 = i + 1; i2 < C; ++i2) {
      const float D = Lq[i2 * RS + d] - li;
      const float w = D <= 0.f ? expf(D) : 1.f;
      const float t = dAs[i2 * AS + i] * Rs[i2 * RS + d];
      dk_in = fmaf(t, w, dk_in);
      if (D <= 0.f) dl_in = fmaf(t, w, dl_in);
    }
    const float daii = dAs[i * AS + i];
    const float gr = dr_in + daii * us[d] * ki + drt * expf(lqi);
    const float gk = dk_in + daii * us[d] * ri + dkt * expf(Lc[d] - li);
    const float dlq = ri * dlq_in + drt * Rt[i * RS + d];
    const float dl = -(ki * dl_in) - dkt * Kt[i * RS + d];
    x_dl[m] = dl + dlq;
    x_dlq[m] = dlq;
    x_t[m] = dkt * Kt[i * RS + d];
    x_u[m] = daii * ri * ki;
    if (t0 + i < S) {
      const size_t g = base + (size_t)(t0 + i) * stride + d;
      dr[g] = from_f32<T>(gr);
      dk[g] = from_f32<T>(gk);
      dv[g] = from_f32<T>(dv_);
    }
  }
  __syncthreads();               // r, k, v and dy are dead
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    const int e = threadIdx.x + m * THREADS;
    if (e >= C * HD) continue;
    const int i = e / HD, d = e % HD;
    Rs[i * RS + d] = x_dl[m];
    Ks[i * RS + d] = x_dlq[m];
    Vs[i * RS + d] = x_t[m];
    Dy[i * RS + d] = x_u[m];
  }
  __syncthreads();
  // one thread per column: Lc's gradient, the reverse cumulative sum and
  // du's partial sum over the chunk's steps
  for (int d = threadIdx.x; d < HD; d += THREADS) {
    float gs = 0.f;
    for (int n = 0; n < HD; ++n) gs = fmaf(Gs[d * RS + n], Ss[d * RS + n], gs);
    float dlc = expf(Lc[d]) * gs;
    float part = 0.f;
    for (int i = 0; i < C; ++i) {
      dlc += Vs[i * RS + d];
      part += Dy[i * RS + d];
    }
    du_part[slot * HD + d] = part;
    float run = dlc;
    for (int i = C - 1; i >= 0; --i) {
      run += Rs[i * RS + d];
      if (t0 + i < S)
        dlw[base + (size_t)(t0 + i) * stride + d] = run - Ks[i * RS + d];
    }
  }
}

// ---------------------------------------------------------------------------
// 4. du[h][d]: the partials summed over batch rows, then chunks
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS) wkv6_bwd_du_kernel(
    const float* __restrict__ du_part, float* __restrict__ du, int B, int H,
    int nc, int HD) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= H * HD) return;
  const int h = e / HD, d = e % HD;
  float acc = 0.f;
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < nc; ++c)
      acc += du_part[(((size_t)b * H + h) * nc + c) * HD + d];
  du[e] = acc;
}

// ---------------------------------------------------------------------------
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const void* lw,
           const void* u, const void* dy, const void* dstate,
           const void* states, void* gstates, void* decay, void* dr, void* dk,
           void* dv, void* dlw, void* du, void* du_part, int B, int S, int H,
           cudaStream_t stream) {
  const int nc = (S + C - 1) / C;
  const size_t smem1 = inc_smem_floats<HD>() * sizeof(float);
  const size_t smem3 = grad_smem_floats<HD>() * sizeof(float);
  cudaError_t err = set_smem(wkv6_bwd_inc_kernel<T, HD>, smem1);
  if (err == cudaSuccess) err = set_smem(wkv6_bwd_grad_kernel<T, HD>, smem3);
  if (err != cudaSuccess) return (int)err;
  const dim3 chunks(nc, H, B);
  wkv6_bwd_inc_kernel<T, HD><<<chunks, THREADS, smem1, stream>>>(
      static_cast<const T*>(r), static_cast<const float*>(lw),
      static_cast<const float*>(dy), static_cast<float*>(gstates),
      static_cast<float*>(decay), S, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 entries((HD * HD + THREADS - 1) / THREADS, H, B);
  wkv6_bwd_scan_kernel<HD><<<entries, THREADS, 0, stream>>>(
      static_cast<float*>(gstates), static_cast<const float*>(decay),
      static_cast<const float*>(dstate), nc, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  wkv6_bwd_grad_kernel<T, HD><<<chunks, THREADS, smem3, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(lw),
      static_cast<const float*>(u), static_cast<const float*>(dy),
      static_cast<const float*>(states), static_cast<const float*>(gstates),
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<float*>(dlw), static_cast<float*>(du_part), S, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  wkv6_bwd_du_kernel<<<(H * HD + THREADS - 1) / THREADS, THREADS, 0,
                       stream>>>(static_cast<const float*>(du_part),
                                 static_cast<float*>(du), B, H, nc, HD);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* r, const void* k, const void* v,
              const void* lw, const void* u, const void* dy,
              const void* dstate, const void* states, void* gstates,
              void* decay, void* dr, void* dk, void* dv, void* dlw, void* du,
              void* du_part, int B, int S, int H, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(r, k, v, lw, u, dy, dstate, states, gstates, decay, dr, dk, dv, dlw, du, du_part, B, S, H, s);
    case 32: return launch<T, 32>(r, k, v, lw, u, dy, dstate, states, gstates, decay, dr, dk, dv, dlw, du, du_part, B, S, H, s);
    case 64: return launch<T, 64>(r, k, v, lw, u, dy, dstate, states, gstates, decay, dr, dk, dv, dlw, du, du_part, B, S, H, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, for r, k, v, dr, dk and dv; lw, dy and dlw
// (B, S, H, hd) float32; u and du (H, hd) float32; dstate (B, H, hd, hd)
// float32, the final state's gradient, or null for none; states
// (B, H, ceil(S / 32), hd, hd) float32, each chunk's incoming state as
// K4's forward leaves its scratch.  Scratch, float32: gstates (the size of
// states), decay (B, H, ceil(S / 32), hd) and du_part (the same).  hd: 16,
// 32 or 64; S >= 1.  Four CUDA launches on `stream`.  Returns the CUDA
// error code of the first launch that fails (0 on success).
int wkv6_bwd_launch(int dtype, int hd, const void* r, const void* k,
                    const void* v, const void* lw, const void* u,
                    const void* dy, const void* dstate, const void* states,
                    void* gstates, void* decay, void* dr, void* dk, void* dv,
                    void* dlw, void* du, void* du_part, int B, int S, int H,
                    void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(hd, r, k, v, lw, u, dy, dstate, states, gstates, decay, dr, dk, dv, dlw, du, du_part, B, S, H, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, r, k, v, lw, u, dy, dstate, states, gstates, decay, dr, dk, dv, dlw, du, du_part, B, S, H, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
