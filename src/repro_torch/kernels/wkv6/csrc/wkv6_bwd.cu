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
//   3. gradients, one block per (chunk, head, batch row), 256 threads,
//      the chunk's operands, its incoming state S_{c-1} (the forward's
//      scratch, which the autograd Function keeps) and G_c in shared
//      memory as f32 (dy, v and K~ also transposed):
//      - dA on register patches of 4 rows x 1 column, patches wholly above
//        the diagonal skipped;
//      - dR~, dK~ and K~ G on patches of 4 rows x 2 columns (hd 64): per
//        k-step a thread loads each operand once (a row quadruple as one
//        16-byte load) for 24 fmas from 9 loads;
//      - the W pass: a thread owns column d and every 4th row i (hd 64);
//        each W[i,j,d], j < i, is computed once, with one exp (__expf, as
//        the forward's A tile), and used
//        for A[i,j] (its sum over d reduced across the lanes of the column
//        range in a fixed order), dr[i,d] (over j, in registers) and
//        dk[j,d] (over the thread's i in registers, then over the four row
//        classes in order through shared memory); the upper triangles of
//        A and dA are not computed;
//      - A^T dy into dv on the product patches;
//      - dr, dk, dv and the chunk's terms of dL, dLq and du on the W pass's
//        rows, then one thread per column for the reverse cumulative sum
//        and du's partial sum over the chunk's steps;
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
// cores (no operand is exact in bf16: S and G are f32).  This chunked form
// also reads the (hd, hd) incoming state and writes and reads the state
// gradient of every chunk.

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
// dst[C][RS]; steps past S are zeros.
// Every thread's loads are issued before its stores (a fixed count each).
template <typename T, int HD, int RS = HD + 1>
__device__ __forceinline__ void load_chunk(float* dst, const T* src,
                                           size_t base, size_t stride,
                                           int t0, int S) {
  static_assert(C * HD % THREADS == 0, "whole rounds");
#pragma unroll
  for (int m = 0; m < C * HD / THREADS; ++m) {
    const int e = threadIdx.x + m * THREADS;
    const int t = e / HD, d = e % HD;
    dst[t * RS + d] = t0 + t < S
                          ? to_f32(src[base + (size_t)(t0 + t) * stride + d])
                          : 0.f;
  }
}

// Inclusive cumulative sums over the steps of each column of x[C][RS] in
// step order (K4's forward order); ex gets the exclusive ones.
template <int HD, int RS = HD + 1>
__device__ __forceinline__ void cumsum_steps(float* x, float* ex) {
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

// n consecutive floats of shared memory (16-byte aligned for 4, 8 for 2).
template <int N>
__device__ __forceinline__ void load_n(float (&x)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else {
    static_assert(N == 2, "load_n");
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x; x[1] = t.y;
  }
}

// ---------------------------------------------------------------------------
// 1. increments: R~^T dy and exp(Lc) of one chunk
// ---------------------------------------------------------------------------
template <int HD>
constexpr size_t inc_smem_floats() {
  return 3 * (size_t)C * (HD + 4);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) wkv6_bwd_inc_kernel(
    const T* __restrict__ r, const float* __restrict__ lw,
    const float* __restrict__ dy, float* __restrict__ gstates,
    float* __restrict__ decay, int S, int H) {
  constexpr int RS = HD + 4;     // 16-byte rows
  extern __shared__ __align__(16) float smem[];
  float* Rs = smem;              // r, then r * exp(Lq)
  float* Ls = Rs + C * RS;       // lw, then L
  float* Lq = Ls + C * RS;       // exclusive sums, then dy
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const size_t stride = (size_t)H * HD;
  const size_t base = (size_t)b * S * stride + (size_t)h * HD;
  load_chunk<T, HD, RS>(Rs, r, base, stride, c * C, S);
  load_chunk<float, HD, RS>(Ls, lw, base, stride, c * C, S);
  __syncthreads();
  cumsum_steps<HD, RS>(Ls, Lq);
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
  load_chunk<float, HD, RS>(Dy, dy, base, stride, c * C, S);
  __syncthreads();
  // out[d][n] = sum_i R~[i][d] dy[i][n] on 4 x 4 patches: per step two
  // 16-byte loads for 16 fmas
  constexpr int NP = HD / 4;
  float* out = gstates + slot * HD * HD;
  for (int p = threadIdx.x; p < NP * NP; p += THREADS) {
    const int d0 = 4 * (p / NP), n0 = 4 * (p % NP);
    float acc[4][4];
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) acc[x][y] = 0.f;
#pragma unroll 8
    for (int i = 0; i < C; ++i) {
      float a[4], g[4];
      load_n<4>(a, Rs + i * RS + d0);
      load_n<4>(g, Dy + i * RS + n0);
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(a[x], g[y], acc[x][y]);
    }
#pragma unroll
    for (int x = 0; x < 4; ++x)
      *reinterpret_cast<float4*>(out + (d0 + x) * HD + n0) =
          make_float4(acc[x][0], acc[x][1], acc[x][2], acc[x][3]);
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
// Shared-memory layout and thread mappings of the gradient launch.  The
// three [C][HD] products (dR~, dK~, K~ G) and A^T dy run on patches of PR
// rows x PC columns a thread (columns cg + CG k); the W pass gives each
// thread one column d and the rows i = q + NQ m of its row class q; a row
// class spans NH warps of LQ lanes.
template <int HD>
struct GradShape {
  static constexpr int RS = HD + 1;         // row stride, [C][HD] tiles
  static constexpr int TS = C + 4;          // row stride, [HD][C] tiles and A
  static constexpr int PC = HD >= 64 ? HD / 32 : 1;
  static constexpr int CG = HD / PC;
  static constexpr int PR = C * CG / THREADS;
  static constexpr int NQ = THREADS / HD;
  static constexpr int RPQ = C / NQ;
  static constexpr int LQ = HD < 32 ? HD : 32;
  static constexpr int NH = HD / LQ;
  // the union, phases 0-3: dy^T, v^T, S_{c-1}, G_c
  static constexpr int DYT = 0, VT = HD * TS, SS = 2 * HD * TS,
                       GS = SS + HD * RS, END0 = GS + HD * RS;
  // the union, phases 3-6: dR~ (then x_dl), dK~ (then x_dlq), dv, the
  // halves of A, dk_in, dl_in, the row classes' x_t and x_u sums
  static constexpr int DRT = 0, DKT = C * HD, DVP = 2 * C * HD,
                       AP = 3 * C * HD, DKC = AP + NH * C * TS,
                       DLC = DKC + C * HD, XT = DLC + C * HD,
                       XU = XT + NQ * HD, END1 = XU + NQ * HD;
  static constexpr int UNION = ((END0 > END1 ? END0 : END1) + 3) / 4 * 4;
  // then K~^T [HD][TS]; r, k, L, Lq, dy [C][RS]; dA [C][AS]; u [HD];
  // G . S in NQ parts [NQ][HD]
  static constexpr size_t FLOATS = (size_t)UNION + HD * TS + 5 * C * RS +
                                   C * AS + HD + NQ * HD;
  static_assert(C % 8 == 0 && C % NQ == 0 && THREADS % HD == 0, "shape");
  static_assert((PR == 2 || PR == 4) && THREADS / CG * PR == C, "patches");
  static_assert(C == 4 * (THREADS / 32), "dA patches: 4 rows x 1 column");
};

// One halving step of reduce8: lanes with bit OFF set keep entries
// H .. 2 H - 1 of v, the others entries 0 .. H - 1, each adding the
// partner's copy of the entries it keeps.
template <int H, int OFF>
__device__ __forceinline__ void halve(float (&v)[8], int lane) {
  const bool up = lane & OFF;
#pragma unroll
  for (int t = 0; t < H; ++t) {
    const float send = up ? v[t] : v[t + H];
    const float keep = up ? v[t + H] : v[t];
    v[t] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

// Eight values per lane summed over each group of LQ lanes, in a fixed
// order (three halving steps, then a butterfly): lane l ends with, in
// v[0], the sum of entry (l % LQ) / (LQ / 8).
template <int LQ>
__device__ __forceinline__ void reduce8(float (&v)[8], int lane) {
  halve<4, LQ / 2>(v, lane);
  halve<2, LQ / 4>(v, lane);
  halve<1, LQ / 8>(v, lane);
#pragma unroll
  for (int off = LQ / 16; off >= 1; off /= 2)
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
}

// One pair (query i, key j < i) of one column: W = exp(min(Lq[i] - L[j],
// 0)) once; its terms of dr and dlq (query i), dk and dl (key j) added;
// returns its term r[i] k[j] W of A[i][j].  As in the forward's A tile
// (wkv6.cu), the exponent is <= 0, where __expf (ex2.approx) errs by under
// 6e-6 relative, under a hundredth of the backward's tolerance.
__device__ __forceinline__ float w_pair(float ri, float lqi, float kj,
                                        float lj, float da, float& dri,
                                        float& dlqi, float& dkj, float& dlj) {
  const float D = lqi - lj;
  const float w = D <= 0.f ? __expf(D) : 1.f;
  const float t1 = da * kj, t2 = da * ri;
  dri = fmaf(t1, w, dri);
  dlqi = fmaf(D <= 0.f ? t1 : 0.f, w, dlqi);
  dkj = fmaf(t2, w, dkj);
  dlj = fmaf(D <= 0.f ? t2 : 0.f, w, dlj);
  return ri * kj * w;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 2) wkv6_bwd_grad_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ lw, const float* __restrict__ u,
    const float* __restrict__ dy, const float* __restrict__ states,
    const float* __restrict__ gstates, T* __restrict__ dr,
    T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dlw,
    float* __restrict__ du_part, int S, int H) {
  using Sh = GradShape<HD>;
  constexpr int RS = Sh::RS, TS = Sh::TS, PC = Sh::PC, CG = Sh::CG;
  constexpr int PR = Sh::PR, NQ = Sh::NQ, RPQ = Sh::RPQ, LQ = Sh::LQ;
  extern __shared__ __align__(16) float smem[];
  float* U = smem;
  float* KtT = smem + Sh::UNION;       // [HD][TS] K~ = k exp(Lc - L), as K~^T
  float* Rs = KtT + HD * TS;           // [C][RS] r
  float* Ks = Rs + C * RS;             // [C][RS] k
  float* Ls = Ks + C * RS;             // [C][RS] lw, then L
  float* Lq = Ls + C * RS;             // [C][RS]
  float* Dy = Lq + C * RS;             // [C][RS] dy
  float* dAs = Dy + C * RS;            // [C][AS] dA (j <= i)
  float* us = dAs + C * AS;            // [HD] u
  float* gsum = us + HD;               // [NQ][HD] parts of G_c . S_{c-1}
  float* DyT = U + Sh::DYT;            // [HD][TS]
  float* VT = U + Sh::VT;              // [HD][TS]
  float* Ss = U + Sh::SS;              // [HD][RS] S_{c-1}
  float* Gs = U + Sh::GS;              // [HD][RS] G_c
  float* DRt = U + Sh::DRT;            // [C][HD] dR~, then x_dl
  float* DKt = U + Sh::DKT;            // [C][HD] dK~, then x_dlq
  float* DVp = U + Sh::DVP;            // [C][HD] dv
  float* Ap = U + Sh::AP;              // [NH][C][TS] A's halves; A in [0]
  float* DKc = U + Sh::DKC;            // [C][HD] dk_in
  float* DLc = U + Sh::DLC;            // [C][HD] dl_in
  float* XT = U + Sh::XT;              // [NQ][HD]
  float* XU = U + Sh::XU;              // [NQ][HD]

  const int tid = threadIdx.x, lane = tid % 32;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int t0 = c * C;
  const size_t stride = (size_t)H * HD;
  const size_t base = (size_t)b * S * stride + (size_t)h * HD;
  const size_t slot = ((size_t)b * H + h) * nc + c;

  // 0. the chunk's operands; dy and v also transposed
  load_chunk<T, HD>(Rs, r, base, stride, t0, S);
  load_chunk<T, HD>(Ks, k, base, stride, t0, S);
  load_chunk<float, HD>(Ls, lw, base, stride, t0, S);
  load_chunk<float, HD>(Dy, dy, base, stride, t0, S);
#pragma unroll
  for (int m = 0; m < C * HD / THREADS; ++m) {
    const int e = tid + m * THREADS;
    const int t = e / HD, d = e % HD;
    const bool in = t0 + t < S;
    const size_t g = base + (size_t)(t0 + t) * stride + d;
    VT[d * TS + t] = in ? to_f32(v[g]) : 0.f;
    DyT[d * TS + t] = in ? dy[g] : 0.f;
  }
#pragma unroll
  for (int m = 0; m < HD * HD / THREADS; ++m) {
    const int e = tid + m * THREADS;
    const int d = e / HD, n = e % HD;
    Ss[d * RS + n] = states[slot * HD * HD + e];
    Gs[d * RS + n] = gstates[slot * HD * HD + e];
  }
  for (int d = tid; d < HD; d += THREADS) us[d] = u[(size_t)h * HD + d];
  __syncthreads();
  // 1. L and Lq
  cumsum_steps<HD>(Ls, Lq);
  __syncthreads();
  // 2. K~^T; dA[i][j] = dy[i] . v[j] on patches of rows 4 w .. 4 w + 3 and
  //    column j = lane, patches wholly above the diagonal skipped; G . S
  const float* Lc = Ls + (C - 1) * RS;
  for (int e = tid; e < C * HD; e += THREADS) {
    const int d = e / C, i = e % C;
    KtT[d * TS + i] = Ks[i * RS + d] * expf(Lc[d] - Ls[i * RS + d]);
  }
  {
    const int i0 = 4 * (tid / 32), j = lane;
    if (j <= i0 + 3) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
      for (int n = 0; n < HD; ++n) {
        float a[4];
        load_n<4>(a, DyT + n * TS + i0);
        const float vj = VT[n * TS + j];
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[x] = fmaf(a[x], vj, acc[x]);
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) dAs[(i0 + x) * AS + j] = acc[x];
    }
  }
  {                                    // G . S, n split over the row classes
    const int q = tid / HD, d = tid % HD;
    float gs = 0.f;
    for (int n = q * (HD / NQ); n < (q + 1) * (HD / NQ); ++n)
      gs = fmaf(Gs[d * RS + n], Ss[d * RS + n], gs);
    gsum[q * HD + d] = gs;
  }
  __syncthreads();

  // 3. dR~ = dy S^T, dK~ = v G^T and K~ G on the patches
  const int cg = tid % CG, r0 = (tid / CG) * PR;
  {
    float drt[PR][PC], dkt[PR][PC], kg[PR][PC];
#pragma unroll
    for (int x = 0; x < PR; ++x)
#pragma unroll
      for (int y = 0; y < PC; ++y) drt[x][y] = dkt[x][y] = kg[x][y] = 0.f;
#pragma unroll 4
    for (int n = 0; n < HD; ++n) {
      float a[PR], bv[PR], kt[PR];
      load_n<PR>(a, DyT + n * TS + r0);
      load_n<PR>(bv, VT + n * TS + r0);
      load_n<PR>(kt, KtT + n * TS + r0);
#pragma unroll
      for (int y = 0; y < PC; ++y) {
        const int col = cg + CG * y;
        const float s = Ss[col * RS + n], g = Gs[col * RS + n];
        const float gt = Gs[n * RS + col];
#pragma unroll
        for (int x = 0; x < PR; ++x) {
          drt[x][y] = fmaf(a[x], s, drt[x][y]);
          dkt[x][y] = fmaf(bv[x], g, dkt[x][y]);
          kg[x][y] = fmaf(kt[x], gt, kg[x][y]);
        }
      }
    }
    __syncthreads();                   // dy^T, v^T, S and G are dead
#pragma unroll
    for (int x = 0; x < PR; ++x)
#pragma unroll
      for (int y = 0; y < PC; ++y) {
        const int e = (r0 + x) * HD + cg + CG * y;
        DRt[e] = drt[x][y];
        DKt[e] = dkt[x][y];
        DVp[e] = kg[x][y];
      }
  }

  // 4. the W pass: each W[i,j,d] = exp(min(Lq[i,d] - L[j,d], 0)), j < i,
  //    computed once and used for A[i,j] (its sum over d reduced across
  //    the row class's lanes), dr_in[i,d] and dlq_in[i,d] (over j, in
  //    registers) and dk_in[j,d] and dl_in[j,d] (over this thread's i,
  //    then over the row classes in order)
  const int q = tid / HD, d = tid % HD, half = d / LQ;
  const float ud = us[d];
  float dkp[C], dlp[C], drr[RPQ], dlqr[RPQ];
#pragma unroll
  for (int j = 0; j < C; ++j) dkp[j] = dlp[j] = 0.f;
  for (int m = 0; m < RPQ; ++m) {
    const int i = q + NQ * m;
    const float ri = Rs[i * RS + d], lqi = Lq[i * RS + d];
    float dri = 0.f, dlqi = 0.f;
#pragma unroll
    for (int cc = 0; cc < C / 8; ++cc) {
      float av[8];
      if (8 * cc + 8 <= i) {           // below the diagonal: no branches
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int j = 8 * cc + t;
          av[t] = w_pair(ri, lqi, Ks[j * RS + d], Ls[j * RS + d],
                         dAs[i * AS + j], dri, dlqi, dkp[j], dlp[j]);
        }
      } else {                         // the diagonal's chunk, and above it
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int j = 8 * cc + t;
          av[t] = 0.f;
          if (j < i)
            av[t] = w_pair(ri, lqi, Ks[j * RS + d], Ls[j * RS + d],
                           dAs[i * AS + j], dri, dlqi, dkp[j], dlp[j]);
          else if (j == i)
            av[t] = ri * ud * Ks[i * RS + d];
        }
      }
      // a chunk wholly above the diagonal is 0 (i is one row per warp at
      // hd >= 32; the vote keeps the shuffles warp-wide at hd 16)
      if (__all_sync(0xffffffffu, 8 * cc > i))
        av[0] = 0.f;
      else
        reduce8<LQ>(av, lane);
      if (lane % (LQ / 8) == 0)
        Ap[(half * C + i) * TS + 8 * cc + (lane % LQ) / (LQ / 8)] = av[0];
    }
#pragma unroll
    for (int mm = 0; mm < RPQ; ++mm)
      if (mm == m) {
        drr[mm] = dri;
        dlqr[mm] = dlqi;
      }
  }
  for (int qq = 0; qq < NQ; ++qq) {
    if (q == qq) {
#pragma unroll
      for (int j = 0; j < C; ++j) {
        DKc[j * HD + d] = qq ? DKc[j * HD + d] + dkp[j] : dkp[j];
        DLc[j * HD + d] = qq ? DLc[j * HD + d] + dlp[j] : dlp[j];
      }
    }
    __syncthreads();
  }
  if (Sh::NH > 1) {
    for (int e = tid; e < C * C; e += THREADS) {
      const int i = e / C, j = e % C;
      Ap[i * TS + j] += Ap[(C + i) * TS + j];
    }
    __syncthreads();
  }
  // dv += A^T dy on the patches (A is 0 above the diagonal)
  {
    float acc[PR][PC];
#pragma unroll
    for (int x = 0; x < PR; ++x)
#pragma unroll
      for (int y = 0; y < PC; ++y)
        acc[x][y] = DVp[(r0 + x) * HD + cg + CG * y];
    for (int i2 = r0; i2 < C; ++i2) {
      float a[PR];
      load_n<PR>(a, Ap + i2 * TS + r0);
#pragma unroll
      for (int y = 0; y < PC; ++y) {
        const float g = Dy[i2 * RS + cg + CG * y];
#pragma unroll
        for (int x = 0; x < PR; ++x) acc[x][y] = fmaf(a[x], g, acc[x][y]);
      }
    }
#pragma unroll
    for (int x = 0; x < PR; ++x)
#pragma unroll
      for (int y = 0; y < PC; ++y)
        DVp[(r0 + x) * HD + cg + CG * y] = acc[x][y];
  }
  __syncthreads();

  // 5. dr, dk, dv and the log-decays' terms, on the W pass's rows
  const float lc = Lc[d];
  float xt = 0.f, xu = 0.f;
  for (int m = 0; m < RPQ; ++m) {
    const int i = q + NQ * m;
    float dri = 0.f, dlqi = 0.f;
#pragma unroll
    for (int mm = 0; mm < RPQ; ++mm)
      if (mm == m) {
        dri = drr[mm];
        dlqi = dlqr[mm];
      }
    const int e = i * HD + d;
    const float ri = Rs[i * RS + d], ki = Ks[i * RS + d];
    const float eq = expf(Lq[i * RS + d]), ek = expf(lc - Ls[i * RS + d]);
    const float rt = ri * eq, kt = ki * ek;
    const float drt = DRt[e], dkt = DKt[e];
    const float daii = dAs[i * AS + i];
    const float gr = dri + daii * ud * ki + drt * eq;
    const float gk = DKc[e] + daii * ud * ri + dkt * ek;
    const float dlq = ri * dlqi + drt * rt;
    const float dl = -(ki * DLc[e]) - dkt * kt;
    DRt[e] = dl + dlq;
    DKt[e] = dlq;
    xt += dkt * kt;
    xu += daii * ri * ki;
    if (t0 + i < S) {
      const size_t g = base + (size_t)(t0 + i) * stride + d;
      dr[g] = from_f32<T>(gr);
      dk[g] = from_f32<T>(gk);
      dv[g] = from_f32<T>(DVp[e]);
    }
  }
  XT[q * HD + d] = xt;
  XU[q * HD + d] = xu;
  __syncthreads();
  // 6. one thread per column: Lc's gradient, the reverse cumulative sum
  //    and du's partial sum over the chunk's steps
  for (int d2 = tid; d2 < HD; d2 += THREADS) {
    float gs = 0.f;
    for (int qq = 0; qq < NQ; ++qq) gs += gsum[qq * HD + d2];
    float dlc = expf(Lc[d2]) * gs;
    float part = 0.f;
    for (int qq = 0; qq < NQ; ++qq) {
      dlc += XT[qq * HD + d2];
      part += XU[qq * HD + d2];
    }
    du_part[slot * HD + d2] = part;
    float run = dlc;
    for (int i = C - 1; i >= 0; --i) {
      run += DRt[i * HD + d2];
      if (t0 + i < S)
        dlw[base + (size_t)(t0 + i) * stride + d2] = run - DKt[i * HD + d2];
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
  const size_t smem3 = GradShape<HD>::FLOATS * sizeof(float);
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
