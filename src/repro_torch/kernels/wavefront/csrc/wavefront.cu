// K1 on Hopper: the anti-diagonal DP matrix fill with a bit-packed
// traceback store.
//
// Replaces the Pallas TPU kernel src/repro/kernels/wavefront/kernel.py,
// function wavefront_fill (body _kernel_body), and computes exactly what it
// computes: per (pair, strip, lane) the running best score over the
// objective region and its first column, and the ('chunk', 32, pack)
// pointer store tb[pair][strip][lane / pack][w], w = lane + j - 1.  The one
// difference is deliberate: the init row and column arrive already masked
// by effective length and band (as core/reference.py masks them), where the
// Pallas kernel loads them unmasked.
//
// Mapping.  One warp fills one pair; lane l is the PE of DP row
// i = 32 c + l + 1 in strip c.  The strips run in order inside the warp
// (the TPU's sequential grid).  The strip's bottom row is carried to the
// next strip through a row buffer of (R + 1) x L int32 in dynamic shared
// memory, one per warp.  The two wavefront carries (prev, prev2) and the
// reference character stream move one lane down per wavefront with
// __shfl_up_sync; lane 0 takes the new reference character and the
// row-buffer values instead.  Each PE family is a device functor fixed at
// compile time (linear, affine, two-piece; DNA match/mismatch or a
// substitution matrix held in shared memory; local or global), and so are
// the objective region and banding.
//
// What bounds it.  Each cell costs a handful of int32 ALU operations per
// score layer (adds, maxes, compares, selects, pointer bit packing) and
// writes only one pointer slot of 8 / pack bits, so the int32 issue rate
// binds before memory bandwidth at every bucket size.
// The design keeps every operand of a cell in registers or shared memory;
// device memory sees the inputs once and the pointer store once, and
// wavefronts past r_len + 31 and strips past q_len are skipped (their
// cells are invalid and read back as END from the zeroed store).  What
// it does not do yet: the pointer store is written one byte per lane-byte
// with a stride of 32 + R - 1 bytes between lanes, so each wavefront's
// store is scattered; one warp per pair leaves most warp slots of an SM
// idle at small batches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N_PE = 32;
constexpr int SENT = -(1 << 30);
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  int match, mismatch, gap, gap_open, gap_extend, gap_open2, gap_extend2;
  int n_sub;  // side of the substitution matrix (0 for DNA scoring)
};

struct DnaSub {
  static constexpr bool kMatrix = false;
  __device__ static int score(const Params& p, const int*, int q, int r) {
    return q == r ? p.match : p.mismatch;
  }
};

struct MatrixSub {
  static constexpr bool kMatrix = true;
  // codes past the matrix clamp to its last row/column
  __device__ static int score(const Params& p, const int* sub, int q, int r) {
    const int n = p.n_sub - 1;
    return sub[min(q, n) * p.n_sub + min(r, n)];
  }
};

// Each cell() follows the comparison order of the PE in
// core/kernels_zoo/common.py: a later candidate wins only when strictly
// greater, which decides the stored pointer under ties.
template <class SubT, bool LOCAL>
struct LinearPE {
  using Sub = SubT;
  static constexpr int L = 1;
  __device__ static int cell(const Params& p, const int* sub, int q, int r,
                             const int* diag, const int* up,
                             const int* left, int* out) {
    const int m = diag[0] + Sub::score(p, sub, q, r);
    const int d = up[0] + p.gap;
    const int ins = left[0] + p.gap;
    int best = m, ptr = 1;
    if (d > best) ptr = 2;
    best = max(best, d);
    if (ins > best) ptr = 3;
    best = max(best, ins);
    if (LOCAL) {
      if (best <= 0) ptr = 0;
      best = max(best, 0);
    }
    out[0] = best;
    return ptr;
  }
};

template <class SubT, bool LOCAL>
struct AffinePE {
  using Sub = SubT;
  static constexpr int L = 3;  // H, I, D
  __device__ static int cell(const Params& p, const int* sub, int q, int r,
                             const int* diag, const int* up,
                             const int* left, int* out) {
    const int ins_open = left[0] + p.gap_open;
    const int ins_ext = left[1] + p.gap_extend;
    const int ins = max(ins_open, ins_ext);
    const int i_ext = ins_ext > ins_open;
    const int del_open = up[0] + p.gap_open;
    const int del_ext = up[2] + p.gap_extend;
    const int dele = max(del_open, del_ext);
    const int d_ext = del_ext > del_open;
    int h = diag[0] + Sub::score(p, sub, q, r);
    int src = 1;
    if (dele > h) src = 2;
    h = max(h, dele);
    if (ins > h) src = 3;
    h = max(h, ins);
    if (LOCAL) {
      if (h <= 0) src = 0;
      h = max(h, 0);
    }
    out[0] = h;
    out[1] = ins;
    out[2] = dele;
    return src | (i_ext << 2) | (d_ext << 3);
  }
};

template <class SubT>
struct TwoPiecePE {
  using Sub = SubT;
  static constexpr int L = 5;  // H, I1, D1, I2, D2
  __device__ static int cell(const Params& p, const int* sub, int q, int r,
                             const int* diag, const int* up,
                             const int* left, int* out) {
    const int i1o = left[0] + p.gap_open, i1x = left[1] + p.gap_extend;
    const int d1o = up[0] + p.gap_open, d1x = up[2] + p.gap_extend;
    const int i2o = left[0] + p.gap_open2, i2x = left[3] + p.gap_extend2;
    const int d2o = up[0] + p.gap_open2, d2x = up[4] + p.gap_extend2;
    const int i1 = max(i1o, i1x), d1 = max(d1o, d1x);
    const int i2 = max(i2o, i2x), d2 = max(d2o, d2x);
    int h = diag[0] + Sub::score(p, sub, q, r);
    int src = 1;
    if (d1 > h) src = 2;
    h = max(h, d1);
    if (i1 > h) src = 3;
    h = max(h, i1);
    if (d2 > h) src = 4;
    h = max(h, d2);
    if (i2 > h) src = 5;
    h = max(h, i2);
    out[0] = h;
    out[1] = i1;
    out[2] = d1;
    out[3] = i2;
    out[4] = d2;
    return src | ((i1x > i1o) << 3) | ((d1x > d1o) << 4) |
           ((i2x > i2o) << 5) | ((d2x > d2o) << 6);
  }
};

// Objective regions: 0 corner, 1 all, 2 last row, 3 last row or column.
template <int REGION>
__device__ __forceinline__ bool region_sel(int i, int j, int q_len,
                                           int r_len) {
  if (REGION == 0) return i == q_len && j == r_len;
  if (REGION == 1) return true;
  if (REGION == 2) return i == q_len;
  return i == q_len || j == r_len;
}

template <class PE, int REGION, bool BANDED>
__global__ void wavefront_kernel(
    const uint8_t* __restrict__ query, const uint8_t* __restrict__ ref,
    const int* __restrict__ init_row, const int* __restrict__ init_col,
    const int* __restrict__ lens, const int* __restrict__ sub_g, Params p,
    int band, uint8_t* __restrict__ tb, int* __restrict__ best_out,
    int* __restrict__ bestj_out, int B, int Q, int R, int pack,
    int with_tb, int warps) {
  constexpr int L = PE::L;
  extern __shared__ int smem[];
  const int sub_ints = PE::Sub::kMatrix ? p.n_sub * p.n_sub : 0;
  if (PE::Sub::kMatrix) {
    for (int t = threadIdx.x; t < sub_ints; t += blockDim.x) smem[t] = sub_g[t];
    __syncthreads();
  }
  const int* sub = smem;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * warps + warp;
  if (b >= B) return;

  int* row_buf = smem + sub_ints + warp * (R + 1) * L;
  const int q_len = lens[2 * b];
  const int r_len = lens[2 * b + 1];
  const int C = Q / N_PE;
  const int WT = N_PE + R - 1;
  const int lane_bytes = N_PE / pack;
  const int width = 8 / pack;
  const unsigned slot_mask = (1u << width) - 1u;
  const uint8_t* qb = query + (size_t)b * Q;
  const uint8_t* rb = ref + (size_t)b * R;
  const int* irow = init_row + (size_t)b * (R + 1) * L;
  const int* icol = init_col + (size_t)b * (Q + 1) * L;

  for (int t = lane; t < (R + 1) * L; t += N_PE) row_buf[t] = irow[t];
  __syncwarp();

  // wavefronts past r_len + N_PE - 2 hold no valid cell in any lane
  const int n_w = min(WT, max(r_len + N_PE - 1, 0));

  for (int c = 0; c < C; ++c) {
    int* bo = best_out + ((size_t)b * C + c) * N_PE;
    int* bjo = bestj_out + ((size_t)b * C + c) * N_PE;
    if (c * N_PE + 1 > q_len) {  // every row of this strip is invalid
      bo[lane] = SENT;
      bjo[lane] = 0;
      continue;
    }
    if (c > 0) {
      // top-left boundary of this strip = init column at row c * N_PE
      if (lane < L) row_buf[lane] = icol[(c * N_PE) * L + lane];
      __syncwarp();
    }
    const int i_glob = c * N_PE + lane + 1;
    const int qc = qb[c * N_PE + lane];
    int col_b[L], col_d[L], prev[L], prev2[L];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      col_b[l] = icol[i_glob * L + l];
      col_d[l] = lane > 0 ? icol[(i_glob - 1) * L + l] : row_buf[l];
      prev[l] = SENT;
      prev2[l] = SENT;
    }
    int rchar = 0;
    int best = SENT, bestj = 0;

    for (int w = 0; w < n_w; ++w) {
      const int j = w - lane + 1;
      // systolic reference stream: lane 0 takes ref[w]
      rchar = __shfl_up_sync(FULL, rchar, 1);
      if (lane == 0) rchar = rb[min(w, R - 1)];
      int up[L], diag[L], left[L];
#pragma unroll
      for (int l = 0; l < L; ++l) {
        up[l] = __shfl_up_sync(FULL, prev[l], 1);
        diag[l] = __shfl_up_sync(FULL, prev2[l], 1);
        left[l] = prev[l];
      }
      if (lane == 0) {
        const int r0 = min(w, R), r1 = min(w + 1, R);
#pragma unroll
        for (int l = 0; l < L; ++l) {
          up[l] = row_buf[r1 * L + l];
          diag[l] = row_buf[r0 * L + l];
        }
      }
      if (lane == w) {  // j == 1: the left and diagonal neighbours are column 0
#pragma unroll
        for (int l = 0; l < L; ++l) {
          left[l] = col_b[l];
          diag[l] = col_d[l];
        }
      }
      int cur[L];
      int ptr = PE::cell(p, sub, qc, rchar, diag, up, left, cur);
      const bool in_band = !BANDED || abs(i_glob - j) <= band;
      const bool valid = j >= 1 && j <= r_len && i_glob <= q_len && in_band;
      if (!valid) {
#pragma unroll
        for (int l = 0; l < L; ++l) cur[l] = SENT;
        ptr = 0;
      }
      if (with_tb) {
        // pack `pack` neighbouring lanes into one byte, lane l in slot l % pack
        unsigned v = ((unsigned)ptr & slot_mask) << ((lane % pack) * width);
        for (int off = 1; off < pack; off <<= 1)
          v |= __shfl_down_sync(FULL, v, off);
        if (lane % pack == 0)
          tb[(((size_t)b * C + c) * lane_bytes + lane / pack) * WT + w] =
              (uint8_t)v;
      }
      // the strip's last PE exports its row into the row buffer
      if (lane == N_PE - 1 && j >= 1 && j <= R) {
#pragma unroll
        for (int l = 0; l < L; ++l) row_buf[j * L + l] = cur[l];
      }
      // per-lane best over the objective region; strict > keeps the first j
      if (valid && region_sel<REGION>(i_glob, j, q_len, r_len) &&
          cur[0] > best) {
        best = cur[0];
        bestj = j;
      }
#pragma unroll
      for (int l = 0; l < L; ++l) {
        prev2[l] = prev[l];
        prev[l] = cur[l];
      }
      __syncwarp();
    }
    bo[lane] = best;
    bjo[lane] = bestj;
    __syncwarp();
  }
}

struct Args {
  const uint8_t* query;
  const uint8_t* ref;
  const int* init_row;
  const int* init_col;
  const int* lens;
  const int* sub;
  Params p;
  int band;
  uint8_t* tb;
  int* best;
  int* best_j;
  int B, Q, R, pack, with_tb, warps;
  cudaStream_t stream;
};

template <class PE, int REGION, bool BANDED>
int launch(const Args& a) {
  auto kern = wavefront_kernel<PE, REGION, BANDED>;
  const int sub_ints = PE::Sub::kMatrix ? a.p.n_sub * a.p.n_sub : 0;
  const size_t smem =
      sizeof(int) * ((size_t)sub_ints + (size_t)a.warps * (a.R + 1) * PE::L);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (a.B + a.warps - 1) / a.warps;
  kern<<<grid, a.warps * N_PE, smem, a.stream>>>(
      a.query, a.ref, a.init_row, a.init_col, a.lens, a.sub, a.p, a.band,
      a.tb, a.best, a.best_j, a.B, a.Q, a.R, a.pack, a.with_tb, a.warps);
  return (int)cudaGetLastError();
}

template <class PE>
int by_region(int region, bool banded, const Args& a) {
  switch (region * 2 + (banded ? 1 : 0)) {
    case 0: return launch<PE, 0, false>(a);
    case 1: return launch<PE, 0, true>(a);
    case 2: return launch<PE, 1, false>(a);
    case 3: return launch<PE, 1, true>(a);
    case 4: return launch<PE, 2, false>(a);
    case 5: return launch<PE, 2, true>(a);
    case 6: return launch<PE, 3, false>(a);
    case 7: return launch<PE, 3, true>(a);
  }
  return (int)cudaErrorInvalidValue;
}

template <class Sub>
int by_family(int family, int local, int region, bool banded, const Args& a) {
  if (family == 0)
    return local ? by_region<LinearPE<Sub, true>>(region, banded, a)
                 : by_region<LinearPE<Sub, false>>(region, banded, a);
  if (family == 1)
    return local ? by_region<AffinePE<Sub, true>>(region, banded, a)
                 : by_region<AffinePE<Sub, false>>(region, banded, a);
  if (family == 2 && !local)
    return by_region<TwoPiecePE<Sub>>(region, banded, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// family: 0 linear, 1 affine, 2 two-piece; matrix: substitution matrix
// scoring (else DNA match/mismatch); region: 0 corner, 1 all, 2 last row,
// 3 last row or column; band < 0: unbanded.  tb may be null when with_tb is
// 0.  Returns the CUDA error code of the launch (0 on success).
int wavefront_fill_launch(
    int family, int matrix, int local, int region, int band,
    const void* query, const void* ref, const void* init_row,
    const void* init_col, const void* lens, const void* sub, int n_sub,
    int match, int mismatch, int gap, int gap_open, int gap_extend,
    int gap_open2, int gap_extend2, void* tb, void* best, void* best_j,
    int B, int Q, int R, int pack, int with_tb, int warps, void* stream) {
  if (B <= 0) return 0;
  Args a;
  a.query = static_cast<const uint8_t*>(query);
  a.ref = static_cast<const uint8_t*>(ref);
  a.init_row = static_cast<const int*>(init_row);
  a.init_col = static_cast<const int*>(init_col);
  a.lens = static_cast<const int*>(lens);
  a.sub = static_cast<const int*>(sub);
  a.p = Params{match, mismatch, gap, gap_open, gap_extend,
               gap_open2, gap_extend2, matrix ? n_sub : 0};
  a.band = band;
  a.tb = static_cast<uint8_t*>(tb);
  a.best = static_cast<int*>(best);
  a.best_j = static_cast<int*>(best_j);
  a.B = B;
  a.Q = Q;
  a.R = R;
  a.pack = pack;
  a.with_tb = with_tb;
  a.warps = warps;
  a.stream = static_cast<cudaStream_t>(stream);
  const bool banded = band >= 0;
  return matrix ? by_family<MatrixSub>(family, local, region, banded, a)
                : by_family<DnaSub>(family, local, region, banded, a);
}

// Largest dynamic shared memory one block may opt into on `device`.
int wavefront_max_smem(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

}  // extern "C"
