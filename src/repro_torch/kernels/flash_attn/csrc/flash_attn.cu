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
//   Shared memory is 87 KB at hd 128, 107.5 KB at hd 160 (rows of 336
//   bytes, 21 16-byte units, still 8 distinct bank groups an ldmatrix) and
//   109 KB at q/k 192 with v 128, so two blocks fit an SM.  At hd 256 the
//   ring of two stages would take 165 KB, one block an SM; it keeps one
//   stage instead (99 KB, two blocks an SM, each hiding the other's loads),
//   and its O accumulator alone is 128 registers a thread, so q's fragments
//   are not held across the k-tiles but read again by ldmatrix at each
//   k-step (QREG below): 243 registers, no spill (ptxas on the H100; 224
//   at 192 / 128, 235 at hd 160).  The grid
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
//   at 2e-5: the CUDA-core kernel of the first port.  One block of 256
//   threads per (64-row q-tile, head, batch row), the tiles widened to f32
//   in shared memory (q and k transposed for float4 reads), a 4 x 4 score
//   patch per thread, one warp per 8 rows for the softmax, p kept in f32,
//   and for p v each thread owning one output column (hd_v dividing 256)
//   or, at hd_v 160, each warp 8 rows and each lane the columns lane + 32 c.
//   Shared memory is 146 KB at hd 160 and 218 KB at hd 256 (within the
//   227 KB a block may have), one block an SM; at hd 256 ptxas keeps 128
//   registers and spills 32 bytes of the 64 accumulators a thread.
//
// Common to both: a loop over 64-row k-tiles inside the block takes the
// place of the TPU's sequential ("arbitrary") k grid axis, and k-tiles
// that lie wholly outside the causal or window band, or at or past k_len,
// are skipped, as _body's pl.when(live) skips them.  Grouped-query
// attention reads key/value head h / (H / Kh) directly (the Pallas wrapper
// repeats k and v in device memory).  Queries and keys have lengths of
// their own, Sq and Sk (cross-attention), as in the JAX model path's
// flash_attention: the grid runs over Sq's tiles and the key loop over
// Sk's, and query row i sits at position q_start + i for the causal and
// window masks (q_start = Sk - Sq: the queries are the keys' last Sq
// positions).  Rows past Sq and keys past Sk are loaded as zeros, masked
// and not stored, so any lengths work (the Pallas kernel needs S to be a
// multiple of its block).  q and k have one width (HDQK) and v and o another
// (HDV): q k^T runs over HDQK, p v and the output over HDV.  The pairs
// built are (d, d) for d in 16, 32, 64, 128, 160 and 256 (recurrentgemma's
// local attention) and (192, 128) (DeepSeek's MLA: q/k carry 128 + 64
// rotary columns, v 128).
//
// What bounds it.  The work is S_live * (hd_qk + hd_v) multiply-adds per
// query row (S_live its unmasked keys; q . k and p v) against one read of q, k, v
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

template <int HDQK, int HDV>
constexpr size_t smem_floats() {
  return (size_t)HDQK * (BQ + PAD) + (size_t)HDQK * (BK + PAD) +
         (size_t)BK * HDV + (size_t)BQ * (BK + PAD) + 3 * BQ;
}

template <typename T, int HDQK, int HDV>
__global__ void __launch_bounds__(THREADS) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
    int Sq, int Sk, int q_start, int H, int Kh, int k_len, int causal,
    int window, float scale) {
  constexpr int QS = BQ + PAD;
  constexpr int KS = BK + PAD;
  // p v: one output column a thread where hd_v divides the block (NRG row
  // groups of RPT rows), else (hd_v 160) 8 rows a warp (WR) and the
  // columns lane + 32 c a lane (NCOL)
  constexpr bool COLS = THREADS % HDV == 0;
  constexpr int NRG = COLS ? THREADS / HDV : 1;
  constexpr int RPT = BQ / NRG;
  constexpr int WR = BQ / (THREADS / 32);
  constexpr int NCOL = HDV / 32;
  constexpr int ACC = COLS ? RPT : WR * NCOL;
  static_assert(COLS ? BQ % NRG == 0 : HDV % 32 == 0, "tiling");
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                  // [HDQK][QS]
  float* Kt = Qt + HDQK * QS;        // [HDQK][KS]
  float* Vs = Kt + HDQK * KS;        // [BK][HDV]
  float* Ps = Vs + BK * HDV;         // [BQ][KS]
  float* row_m = Ps + BQ * KS;
  float* row_l = row_m + BQ;
  float* row_a = row_l + BQ;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;            // the tile's first row
  const int qa0 = q_start + q0;              // and its position
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / Kh);
  const size_t q_stride = (size_t)H * HDQK;  // between positions
  const size_t o_stride = (size_t)H * HDV;
  const size_t k_stride = (size_t)Kh * HDQK;
  const size_t v_stride = (size_t)Kh * HDV;
  const T* qb = q + (size_t)b * Sq * q_stride + (size_t)h * HDQK;
  const T* kb = k + (size_t)b * Sk * k_stride + (size_t)kh * HDQK;
  const T* vb = v + (size_t)b * Sk * v_stride + (size_t)kh * HDV;
  T* ob = o + (size_t)b * Sq * o_stride + (size_t)h * HDV;

  for (int e = tid; e < BQ * HDQK; e += THREADS) {
    const int i = e % BQ, d = e / BQ;
    const int pos = q0 + i;
    Qt[d * QS + i] = pos < Sq ? to_f32(qb[(size_t)pos * q_stride + d]) : 0.f;
  }
  if (tid < BQ) {
    row_m[tid] = NEG_INF;
    row_l[tid] = 0.f;
  }
  const int od = tid % HDV;
  const int org = tid / HDV;
  float acc[ACC];
#pragma unroll
  for (int r = 0; r < ACC; ++r) acc[r] = 0.f;

  const int tx = tid % 16;   // score patch: columns 4 tx .. 4 tx + 3
  const int ty = tid / 16;   //              rows    4 ty .. 4 ty + 3
  const int warp = tid / 32, lane = tid % 32;
  const int n_k = (Sk + BK - 1) / BK;

  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    if (!tile_live(k0, qa0, k_len, causal, window)) continue;  // uniform
    __syncthreads();       // the previous tile's readers are done
    for (int e = tid; e < BK * HDQK; e += THREADS) {
      const int j = e % BK, d = e / BK;
      const int pos = k0 + j;
      Kt[d * KS + j] =
          pos < Sk ? to_f32(kb[(size_t)pos * k_stride + d]) : 0.f;
    }
    for (int e = tid; e < BK * HDV; e += THREADS) {
      const int j = e / HDV, d = e % HDV;
      const int pos = k0 + j;
      Vs[j * HDV + d] =
          pos < Sk ? to_f32(vb[(size_t)pos * v_stride + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HDQK; ++d) {
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
      const int qpos = qa0 + 4 * ty + a;
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

    if constexpr (COLS) {
#pragma unroll
      for (int r = 0; r < RPT; ++r) acc[r] *= row_a[org + NRG * r];
      for (int j = 0; j < BK; j += 4) {
        const float v0 = Vs[(j + 0) * HDV + od], v1 = Vs[(j + 1) * HDV + od];
        const float v2 = Vs[(j + 2) * HDV + od], v3 = Vs[(j + 3) * HDV + od];
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const float4 p = *reinterpret_cast<const float4*>(
              &Ps[(org + NRG * r) * KS + j]);
          acc[r] = fmaf(p.x, v0, acc[r]);
          acc[r] = fmaf(p.y, v1, acc[r]);
          acc[r] = fmaf(p.z, v2, acc[r]);
          acc[r] = fmaf(p.w, v3, acc[r]);
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < WR; ++r)
#pragma unroll
        for (int c = 0; c < NCOL; ++c) acc[r * NCOL + c] *= row_a[warp * WR + r];
      for (int j = 0; j < BK; j += 4) {
        float vv[4][NCOL];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int c = 0; c < NCOL; ++c)
            vv[jj][c] = Vs[(j + jj) * HDV + lane + 32 * c];
#pragma unroll
        for (int r = 0; r < WR; ++r) {
          const float4 p = *reinterpret_cast<const float4*>(
              &Ps[(warp * WR + r) * KS + j]);
#pragma unroll
          for (int c = 0; c < NCOL; ++c) {
            float& a = acc[r * NCOL + c];
            a = fmaf(p.x, vv[0][c], a);
            a = fmaf(p.y, vv[1][c], a);
            a = fmaf(p.z, vv[2][c], a);
            a = fmaf(p.w, vv[3][c], a);
          }
        }
      }
    }
  }
  __syncthreads();
  if constexpr (COLS) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int i = org + NRG * r;
      const int pos = q0 + i;
      if (pos < Sq)
        store(&ob[(size_t)pos * o_stride + od],
              acc[r] / fmaxf(row_l[i], 1e-30f));
    }
  } else {
#pragma unroll
    for (int r = 0; r < WR; ++r) {
      const int i = warp * WR + r;
      const int pos = q0 + i;
      if (pos >= Sq) continue;
      const float l = fmaxf(row_l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < NCOL; ++c)
        store(&ob[(size_t)pos * o_stride + lane + 32 * c],
              acc[r * NCOL + c] / l);
    }
  }
  if (lse != nullptr && tid < BQ && q0 + tid < Sq)
    lse[((size_t)b * Sq + q0 + tid) * H + h] =
        row_m[tid] + logf(fmaxf(row_l[tid], 1e-30f));
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel (serving path)
// ---------------------------------------------------------------------------
constexpr int MMA_WARPS = 4;             // 16 query rows each
constexpr int MMA_THREADS = 32 * MMA_WARPS;
static_assert(BQ == 16 * MMA_WARPS && BQ == BK && BK == TILE_ROWS,
              "mma tiling");

// The k/v ring's stages: two where two blocks still fit an SM (half of its
// 228 KB less 1 KB reserved a block), else one.
template <int HDQK, int HDV>
struct MmaStages {
  static constexpr int value =
      (BQ + 2 * BK) * (HDQK + SPAD) * 2 + 2 * BK * (HDV + SPAD) * 2 <=
              113 * 1024
          ? 2
          : 1;
};

template <int HDQK, int HDV>
constexpr size_t mma_smem_bytes() {      // q-tile, then the stages of k and v
  constexpr int st = MmaStages<HDQK, HDV>::value;
  return (size_t)(BQ + st * BK) * (HDQK + SPAD) * sizeof(bf16) +
         (size_t)st * BK * (HDV + SPAD) * sizeof(bf16);
}

template <int HDQK, int HDV>
__global__ void __launch_bounds__(MMA_THREADS, 2) flash_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
    int Sq, int Sk, int q_start, int H, int Kh, int k_len, int causal,
    int window, float scale) {
  static_assert(HDQK % 16 == 0 && HDV % 16 == 0, "head width");
  constexpr int RQ = HDQK + SPAD;        // row strides of q/k and of v
  constexpr int RV = HDV + SPAD;
  constexpr int KSTEPS = HDQK / 16;      // k16 steps of q k^T
  constexpr int NT = HDV / 8;            // n8 tiles of the output
  constexpr int ST = BK / 8;             // n8 tiles of the scores
  constexpr int STAGES = MmaStages<HDQK, HDV>::value;
  // q's A fragments held in registers across the k-tiles, unless they and
  // the O accumulator would take more than 160 registers a thread (hd 256:
  // 64 + 128); then read again by ldmatrix at each k-step
  constexpr bool QREG = 4 * KSTEPS + 4 * NT <= 160;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][RQ]
  bf16* Ks = Qs + BQ * RQ;                         // [STAGES][BK][RQ]
  bf16* Vs = Ks + STAGES * BK * RQ;                // [STAGES][BK][RV]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;  // fragment row, column pair
  // Blocks start in order of x, then y: every head of the last q-tile
  // first, so the heaviest blocks (most live k-tiles under a causal mask)
  // start before the light ones across the whole launch.
  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the tile's first row
  const int qa0 = q_start + q0;                      // and its position
  const int b = blockIdx.z;
  const int kh = h / (H / Kh);
  const size_t q_stride = (size_t)H * HDQK;
  const size_t o_stride = (size_t)H * HDV;
  const size_t k_stride = (size_t)Kh * HDQK;
  const size_t v_stride = (size_t)Kh * HDV;
  const bf16* qb = q + (size_t)b * Sq * q_stride + (size_t)h * HDQK;
  const bf16* kb = k + (size_t)b * Sk * k_stride + (size_t)kh * HDQK;
  const bf16* vb = v + (size_t)b * Sk * v_stride + (size_t)kh * HDV;
  bf16* ob = o + (size_t)b * Sq * o_stride + (size_t)h * HDV;

  // Each condition of tile_live is monotone in k0, so the live k-tiles
  // are one run kt_lo .. kt_hi.
  const int n_k = (Sk + BK - 1) / BK;
  int kt_lo = n_k, kt_hi = -1;
  for (int kt = 0; kt < n_k; ++kt)
    if (tile_live(kt * BK, qa0, k_len, causal, window)) {
      kt_lo = min(kt_lo, kt);
      kt_hi = kt;
    }

  load_tile<HDQK, MMA_THREADS>(Qs, qb, q_stride, q0, Sq);
  if (kt_lo <= kt_hi) {
    load_tile<HDQK, MMA_THREADS>(Ks, kb, k_stride, kt_lo * BK, Sk);
    load_tile<HDV, MMA_THREADS>(Vs, vb, v_stride, kt_lo * BK, Sk);
  }
  cp_async_commit();

  const int row_w = 16 * warp;           // the warp's first row in the tile
  uint32_t qf[QREG ? KSTEPS : 1][4];
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};     // rows g and g + 8
  float l_r[2] = {0.f, 0.f};             // this lane's share of the row sum

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    int st = 0;
    if constexpr (STAGES == 2) {
      st = (kt - kt_lo) & 1;
      if (kt < kt_hi) {                  // the next tile, into the other stage
        load_tile<HDQK, MMA_THREADS>(Ks + (st ^ 1) * BK * RQ, kb, k_stride,
                                     (kt + 1) * BK, Sk);
        load_tile<HDV, MMA_THREADS>(Vs + (st ^ 1) * BK * RV, vb, v_stride,
                                    (kt + 1) * BK, Sk);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      if (kt > kt_lo) {                  // the last tile's readers are done
        load_tile<HDQK, MMA_THREADS>(Ks, kb, k_stride, kt * BK, Sk);
        load_tile<HDV, MMA_THREADS>(Vs, vb, v_stride, kt * BK, Sk);
        cp_async_commit();
      }
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (QREG) {
      if (kt == kt_lo) {
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks)
          ldmatrix_x4(qf[ks], smem_addr(Qs + (row_w + lane % 16) * RQ +
                                        ks * 16 + (lane / 16) * 8));
      }
    }
    const bf16* Kt = Ks + st * BK * RQ;
    const bf16* Vt = Vs + st * BK * RV;

    // s = q k^T: octet n of keys in s[n]
    float s[ST][4];
#pragma unroll
    for (int n = 0; n < ST; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      uint32_t qa[4];
      if constexpr (QREG) {
#pragma unroll
        for (int r = 0; r < 4; ++r) qa[r] = qf[ks][r];
      } else {
        ldmatrix_x4(qa, smem_addr(Qs + (row_w + lane % 16) * RQ + ks * 16 +
                                  (lane / 16) * 8));
      }
#pragma unroll
      for (int n = 0; n < ST; n += 2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, smem_addr(Kt + (n * 8 + lane % 8 + (lane / 16) * 8) * RQ +
                                  ks * 16 + ((lane / 8) % 2) * 8));
        mma_bf16(s[n], qa, kf[0], kf[1]);
        mma_bf16(s[n + 1], qa, kf[2], kf[3]);
      }
    }

    // scale, mask (element c of octet n: row g + 8 (c / 2), key
    // 8 n + 2 tig + c % 2), row max
    const int k0 = kt * BK;
    const bool edge = k0 + BK > k_len || (causal && k0 + BK - 1 > qa0) ||
                      (window > 0 && k0 <= qa0 + BQ - 1 - window);
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int n = 0; n < ST; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[n][c] * scale;
        if (edge) {
          const int qpos = qa0 + row_w + g + 8 * (c / 2);
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
                                              ((lane / 8) % 2) * 8) * RV +
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
    if (pos >= Sq) continue;
    if (lse != nullptr && tig == 0)
      lse[((size_t)b * Sq + pos) * H + h] = m_r[r] + logf(l_r[r]);
    bf16* orow = ob + (size_t)pos * o_stride + 2 * tig;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) = __floats2bfloat162_rn(
          acc[n][2 * r] / l_r[r], acc[n][2 * r + 1] / l_r[r]);
  }
}

// ---------------------------------------------------------------------------
struct Args {                // the launch's shapes and masks
  int B, Sq, Sk, q_start, H, Kh, k_len, causal, window;
  float scale;
};

template <int HDQK, int HDV>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<HDQK, HDV>() * sizeof(float);
  static_assert(smem <= 232448, "f32 tiles exceed a block's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<float, HDQK, HDV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  flash_kernel<float, HDQK, HDV><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, a.Sq, a.Sk,
      a.q_start, a.H, a.Kh, a.k_len, a.causal, a.window, a.scale);
  return (int)cudaGetLastError();
}

template <int HDQK, int HDV>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, const Args& a, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<HDQK, HDV>();
  static_assert(smem <= 232448, "bf16 tiles exceed a block's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<HDQK, HDV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.H, (a.Sq + BQ - 1) / BQ, a.B);
  flash_mma_kernel<HDQK, HDV><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, a.Sq, a.Sk,
      a.q_start, a.H, a.Kh, a.k_len, a.causal, a.window, a.scale);
  return (int)cudaGetLastError();
}

template <int HDQK, int HDV>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           float* lse, const Args& a, cudaStream_t s) {
  if (dtype == 0) return launch_f32<HDQK, HDV>(q, k, v, o, lse, a, s);
  if (dtype == 1) return launch_bf16<HDQK, HDV>(q, k, v, o, lse, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32 (CUDA-core kernel, p in f32), 1 bfloat16 (tensor-core
// kernel, p rounded to bf16 for p v); q, k, v and o alike.  (hd, hd_v):
// (16, 16), (32, 32), (64, 64), (128, 128), (160, 160), (256, 256) or
// (192, 128); q (B, Sq, H, hd), k (B, Sk, Kh, hd), v (B, Sk, Kh, hd_v) and
// o (B, Sq, H, hd_v), contiguous, 16-byte aligned; query row i sits at
// position q_start + i for the causal and window masks; k_len <= Sk keys
// are live; window <= 0: no window.  lse, if not null, (B, Sq, H) float32,
// gets each row's log-sum-exp m + log(max(l, 1e-30)) of its f32 scores, as
// JAX's _flash_fwd returns it for the backward.  One CUDA launch.  Returns
// the CUDA error code of the launch (0 on success).
int flash_fill_launch(int dtype, int hd, int hd_v, const void* q,
                      const void* k, const void* v, void* o, void* lse, int B,
                      int Sq, int Sk, int q_start, int H, int Kh, int k_len,
                      int causal, int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (Sk < 0 || Kh <= 0 || H % Kh) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const Args a{B, Sq, Sk, q_start, H, Kh, k_len, causal, window, scale};
  if (hd == hd_v) {
    switch (hd) {
      case 16: return launch<16, 16>(dtype, q, k, v, o, l, a, s);
      case 32: return launch<32, 32>(dtype, q, k, v, o, l, a, s);
      case 64: return launch<64, 64>(dtype, q, k, v, o, l, a, s);
      case 128: return launch<128, 128>(dtype, q, k, v, o, l, a, s);
      case 160: return launch<160, 160>(dtype, q, k, v, o, l, a, s);
      case 256: return launch<256, 256>(dtype, q, k, v, o, l, a, s);
    }
  } else if (hd == 192 && hd_v == 128) {
    return launch<192, 128>(dtype, q, k, v, o, l, a, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
