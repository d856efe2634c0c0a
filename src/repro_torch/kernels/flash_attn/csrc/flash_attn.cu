// K3 on Hopper: blockwise online-softmax attention (the forward pass of
// flash attention).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attn/kernel.py,
// function flash_fill (body _body), with its wrapper ops.py::flash, and
// computes what they compute: softmax(q k^T * scale) v per (batch, head)
// under causal, sliding-window and key-length masks, with the scores, the
// running row maximum, the row sum and the accumulator in f32, and the
// output in q's type.  Masked scores take the finite sentinel -1e30 (never
// -inf): a row whose first live tile is fully masked then sees
// exp(s - m) = 1 there, and the first tile with a live key rescales that
// by exp(-1e30 - m) = 0.  The sum is clamped at 1e-30 before the divide.
//
// Two kernels, one per input type:
//
// * bf16 (flash_mma_kernel) is the serving path.  It runs on the tensor
//   cores: q k^T and p v are mma.sync.m16n8k16 bf16 products with f32
//   accumulators in registers.  p is summed into the row sum in f32 and
//   rounded to bf16 for p v, as the JAX model path does
//   (models/layers.py::_flash_fwd casts p to v's type); the Pallas kernel
//   keeps p in f32.  One block of 4 warps per (64-row q-tile, head, batch
//   row); each warp owns 16 query rows.  q, k and v stay bf16 in shared
//   memory (rows padded by 16 bytes, so the 8 row addresses of an ldmatrix
//   fall in distinct bank groups); the k- and v-tiles arrive by cp.async
//   into a ring of two stages, the next tile loading while the current one
//   is multiplied.  q's fragments are loaded once (ldmatrix), k's by
//   ldmatrix and v's by ldmatrix.trans.  The score fragments become p's A
//   fragments in registers (the m16n8 accumulator layout of two adjacent
//   key octets is the m16n8k16 A layout), and the row max and sum stay in
//   registers: each row lives in one quad of lanes, reduced by two
//   shuffles.  The masks, the scale and the sentinel act on the f32 score
//   fragments; an element's row and key follow the mma fragment layout.
//   Shared memory is 87 KB at hd 128, so two blocks fit an SM.  The grid
//   is (head, q-tile, batch row) with the last q-tile first, so under a
//   causal mask the blocks with the most live k-tiles start first across
//   the whole launch and the light ones fill the tail.  The cp.async,
//   ldmatrix and mma helpers live in mma_bf16.cuh, shared with the
//   backward (flash_attn_bwd.cu).
//   mma.sync, not wgmma: wgmma's shared-memory descriptors must match the
//   swizzle the tiles were written in, and a mismatch gives wrong numbers,
//   not a fault; without a compiler or card to iterate on, the mma.sync
//   fragment layouts were the ones that could be made right first.
// * f32 (flash_kernel) is the correctness path, held to the Pallas kernel
//   at 2e-5: the CUDA-core kernel of the first port, unchanged.  One block
//   of 256 threads per (64-row q-tile, head, batch row), the tiles widened
//   to f32 in shared memory (q and k transposed for float4 reads), a 4 x 4
//   score patch per thread, one warp per 8 rows for the softmax, p kept in
//   f32, and each thread owning one output column for p v.
//
// Common to both: a loop over 64-row k-tiles inside the block takes the
// place of the TPU's sequential ("arbitrary") k grid axis, and k-tiles
// that lie wholly outside the causal or window band, or at or past k_len,
// are skipped, as _body's pl.when(live) skips them.  Grouped-query
// attention reads key/value head h / (H / Kh) directly (the Pallas wrapper
// repeats k and v in device memory).  Rows and keys past S are loaded as
// zeros, masked and not stored, so any S works (the Pallas kernel needs S
// to be a multiple of its block).
//
// What bounds it.  The work is 2 * S_live * hd multiply-adds per query row
// (S_live its unmasked keys; q . k and p v) against one read of q, k, v
// and one write of o: far above the card's bytes-to-operations balance,
// so the arithmetic rate binds: 989 TFLOP/s of bf16 on the tensor cores
// (wgmma's rate; mma.sync reaches a part of it), 67 TFLOP/s of f32 on the
// CUDA cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;       // q-tile rows
constexpr int BK = 64;       // k-tile rows
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ bool tile_live(int k0, int q0, int k_len,
                                          int causal, int window) {
  bool live = k0 < k_len;
  if (causal) live = live && k0 <= q0 + BQ - 1;
  if (window > 0) live = live && k0 + BK - 1 > q0 - window;
  return live;
}

// ---------------------------------------------------------------------------
// f32: the CUDA-core kernel (correctness path)
// ---------------------------------------------------------------------------
constexpr int PAD = 4;       // row padding of the transposed tiles (floats)
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
    int S, int H, int Kh, int k_len, int causal, int window, float scale) {
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
    if (!tile_live(k0, q0, k_len, causal, window)) continue;  // block-uniform
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
  if (lse != nullptr && tid < BQ && q0 + tid < S)
    lse[((size_t)b * S + q0 + tid) * H + h] =
        row_m[tid] + logf(fmaxf(row_l[tid], 1e-30f));
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel (serving path)
// ---------------------------------------------------------------------------
constexpr int MMA_WARPS = 4;             // 16 query rows each
constexpr int MMA_THREADS = 32 * MMA_WARPS;
static_assert(BQ == 16 * MMA_WARPS && BQ == BK && BK == TILE_ROWS,
              "mma tiling");

template <int HD>
constexpr size_t mma_smem_bytes() {      // q-tile, then 2 stages of k and v
  return (size_t)(BQ + 4 * BK) * (HD + SPAD) * sizeof(bf16);
}

template <int HD>
__global__ void __launch_bounds__(MMA_THREADS, 2) flash_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
    int S, int H, int Kh, int k_len, int causal, int window, float scale) {
  static_assert(HD % 16 == 0, "head width");
  constexpr int RS = HD + SPAD;
  constexpr int KSTEPS = HD / 16;        // k16 steps of q k^T
  constexpr int NT = HD / 8;             // n8 tiles of the output
  constexpr int ST = BK / 8;             // n8 tiles of the scores
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][RS]
  bf16* Ks = Qs + BQ * RS;                         // [2][BK][RS]
  bf16* Vs = Ks + 2 * BK * RS;                     // [2][BK][RS]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;  // fragment row, column pair
  // Blocks start in order of x, then y: every head of the last q-tile
  // first, so the heaviest blocks (most live k-tiles under a causal mask)
  // start before the light ones across the whole launch.
  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = blockIdx.z;
  const int kh = h / (H / Kh);
  const size_t q_stride = (size_t)H * HD;
  const size_t kv_stride = (size_t)Kh * HD;
  const bf16* qb = q + (size_t)b * S * q_stride + (size_t)h * HD;
  const bf16* kb = k + (size_t)b * S * kv_stride + (size_t)kh * HD;
  const bf16* vb = v + (size_t)b * S * kv_stride + (size_t)kh * HD;
  bf16* ob = o + (size_t)b * S * q_stride + (size_t)h * HD;

  // Each condition of tile_live is monotone in k0, so the live k-tiles
  // are one run kt_lo .. kt_hi.
  const int n_k = (S + BK - 1) / BK;
  int kt_lo = n_k, kt_hi = -1;
  for (int kt = 0; kt < n_k; ++kt)
    if (tile_live(kt * BK, q0, k_len, causal, window)) {
      kt_lo = min(kt_lo, kt);
      kt_hi = kt;
    }

  load_tile<HD, MMA_THREADS>(Qs, qb, q_stride, q0, S);
  if (kt_lo <= kt_hi) {
    load_tile<HD, MMA_THREADS>(Ks, kb, kv_stride, kt_lo * BK, S);
    load_tile<HD, MMA_THREADS>(Vs, vb, kv_stride, kt_lo * BK, S);
  }
  cp_async_commit();

  const int row_w = 16 * warp;           // the warp's first row in the tile
  uint32_t qf[KSTEPS][4];
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};     // rows g and g + 8
  float l_r[2] = {0.f, 0.f};             // this lane's share of the row sum

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int st = (kt - kt_lo) & 1;
    if (kt < kt_hi) {                    // the next tile, into the other stage
      load_tile<HD, MMA_THREADS>(Ks + (st ^ 1) * BK * RS, kb, kv_stride,
                                 (kt + 1) * BK, S);
      load_tile<HD, MMA_THREADS>(Vs + (st ^ 1) * BK * RS, vb, kv_stride,
                                 (kt + 1) * BK, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == kt_lo) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
        ldmatrix_x4(qf[ks], smem_addr(Qs + (row_w + lane % 16) * RS +
                                      ks * 16 + (lane / 16) * 8));
    }
    const bf16* Kt = Ks + st * BK * RS;
    const bf16* Vt = Vs + st * BK * RS;

    // s = q k^T: octet n of keys in s[n]
    float s[ST][4];
#pragma unroll
    for (int n = 0; n < ST; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
      for (int n = 0; n < ST; n += 2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, smem_addr(Kt + (n * 8 + lane % 8 + (lane / 16) * 8) * RS +
                                  ks * 16 + ((lane / 8) % 2) * 8));
        mma_bf16(s[n], qf[ks], kf[0], kf[1]);
        mma_bf16(s[n + 1], qf[ks], kf[2], kf[3]);
      }

    // scale, mask (element c of octet n: row g + 8 (c / 2), key
    // 8 n + 2 tig + c % 2), row max
    const int k0 = kt * BK;
    const bool edge = k0 + BK > k_len || (causal && k0 + BK - 1 > q0) ||
                      (window > 0 && k0 <= q0 + BQ - 1 - window);
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int n = 0; n < ST; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[n][c] * scale;
        if (edge) {
          const int qpos = q0 + row_w + g + 8 * (c / 2);
          const int kpos = k0 + 8 * n + 2 * tig + c % 2;
          bool ok = kpos < k_len;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          x = ok ? x : NEG_INF;
        }
        s[n][c] = x;
        mx[c / 2] = fmaxf(mx[c / 2], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = expf(m_r[r] - mx[r]);
      m_r[r] = mx[r];
      l_r[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < ST; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[n][c] - m_r[c / 2]);
        s[n][c] = p;
        l_r[c / 2] += p;               // the sum takes p in f32
      }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // acc += p v, p rounded to bf16: keys 16 j .. 16 j + 15 are octets
    // 2 j and 2 j + 1 of s
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, smem_addr(Vt + (16 * j + lane % 8 +
                                              ((lane / 8) % 2) * 8) * RS +
                                        n * 8 + (lane / 16) * 8));
        mma_bf16(acc[n], pa, vf[0], vf[1]);
        mma_bf16(acc[n + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();                     // stage st is free for the refill
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    l_r[r] = fmaxf(l_r[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = q0 + row_w + g + 8 * r;
    if (pos >= S) continue;
    if (lse != nullptr && tig == 0)
      lse[((size_t)b * S + pos) * H + h] = m_r[r] + logf(l_r[r]);
    bf16* orow = ob + (size_t)pos * q_stride + 2 * tig;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) = __floats2bfloat162_rn(
          acc[n][2 * r] / l_r[r], acc[n][2 * r + 1] / l_r[r]);
  }
}

// ---------------------------------------------------------------------------
template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int S, int H, int Kh, int k_len,
               int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<float, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_kernel<float, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, H, Kh,
      k_len, causal, window, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int S, int H, int Kh, int k_len,
                int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, (S + BQ - 1) / BQ, B);
  flash_mma_kernel<HD><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, S, H, Kh,
      k_len, causal, window, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           float* lse, int B, int S, int H, int Kh, int k_len, int causal,
           int window, float scale, cudaStream_t s) {
  if (dtype == 0)
    return launch_f32<HD>(q, k, v, o, lse, B, S, H, Kh, k_len, causal, window, scale, s);
  if (dtype == 1)
    return launch_bf16<HD>(q, k, v, o, lse, B, S, H, Kh, k_len, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32 (CUDA-core kernel, p in f32), 1 bfloat16 (tensor-core
// kernel, p rounded to bf16 for p v); q, k, v and o alike.  hd: 16, 32, 64
// or 128; q/o (B, S, H, hd) and k/v (B, S, Kh, hd), contiguous, 16-byte
// aligned; k_len <= S keys are live; window <= 0: no window.  lse, if not
// null, (B, S, H) float32, gets each row's log-sum-exp m + log(max(l,
// 1e-30)) of its f32 scores, as JAX's _flash_fwd returns it for the
// backward.  One CUDA launch.  Returns the CUDA error code of the launch
// (0 on success).
int flash_fill_launch(int dtype, int hd, const void* q, const void* k,
                      const void* v, void* o, void* lse, int B, int S, int H,
                      int Kh, int k_len, int causal, int window, float scale,
                      void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (Kh <= 0 || H % Kh) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (hd) {
    case 16: return launch<16>(dtype, q, k, v, o, l, B, S, H, Kh, k_len, causal, window, scale, s);
    case 32: return launch<32>(dtype, q, k, v, o, l, B, S, H, Kh, k_len, causal, window, scale, s);
    case 64: return launch<64>(dtype, q, k, v, o, l, B, S, H, Kh, k_len, causal, window, scale, s);
    case 128: return launch<128>(dtype, q, k, v, o, l, B, S, H, Kh, k_len, causal, window, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
