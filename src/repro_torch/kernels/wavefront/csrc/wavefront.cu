// K1 for the gap-model families: int32 max-plus linear, affine (Gotoh)
// and two-piece affine PEs with DNA match/mismatch or matrix substitution
// scores, the zoo's kernels #1-7, #11-13 and #15 and the read mapper's
// extensions.  The kernel itself, its mapping onto the card and what bounds
// it are in wavefront_kernel.cuh; wavefront_ext.cu instantiates it on the
// other families.

#include "wavefront_kernel.cuh"

namespace {

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
// greater, which decides the stored pointer under ties.  UP is the mask of
// the layers the PE reads from the cell above; every PE reads only layer 0
// (H) of the diagonal neighbour.  Scores are int32, codes bytes.
struct GapModel : Scores<int, OBJ_MAX> {
  using Char = uint8_t;
  static constexpr unsigned DIAG = 0x1;
  static constexpr int PRIMARY = 0;
};

template <class SubT, bool LOCAL>
struct LinearPE : GapModel {
  using Sub = SubT;
  static constexpr bool kTable = SubT::kMatrix;
  static constexpr int L = 1;
  static constexpr unsigned UP = 0x1;
  __device__ __forceinline__ static int cell(const Params& p,
                                             const unsigned* tab, int q, int r,
                                             const int* diag, const int* up,
                                             const int* left, int* out) {
    const int* sub = reinterpret_cast<const int*>(tab);
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
struct AffinePE : GapModel {
  using Sub = SubT;
  static constexpr bool kTable = SubT::kMatrix;
  static constexpr int L = 3;  // H, I, D
  static constexpr unsigned UP = 0x5;
  __device__ __forceinline__ static int cell(const Params& p,
                                             const unsigned* tab, int q, int r,
                                             const int* diag, const int* up,
                                             const int* left, int* out) {
    const int* sub = reinterpret_cast<const int*>(tab);
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
struct TwoPiecePE : GapModel {
  using Sub = SubT;
  static constexpr bool kTable = SubT::kMatrix;
  static constexpr int L = 5;  // H, I1, D1, I2, D2
  static constexpr unsigned UP = 0x15;
  __device__ __forceinline__ static int cell(const Params& p,
                                             const unsigned* tab, int q, int r,
                                             const int* diag, const int* up,
                                             const int* left, int* out) {
    const int* sub = reinterpret_cast<const int*>(tab);
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

template <class PE>
int by_region(int region, bool banded, const KArgs& a, cudaStream_t s) {
  switch (region * 2 + (banded ? 1 : 0)) {
    case 0: return launch<PE, 0, false>(a, s);
    case 1: return launch<PE, 0, true>(a, s);
    case 2: return launch<PE, 1, false>(a, s);
    case 3: return launch<PE, 1, true>(a, s);
    case 4: return launch<PE, 2, false>(a, s);
    case 5: return launch<PE, 2, true>(a, s);
    case 6: return launch<PE, 3, false>(a, s);
    case 7: return launch<PE, 3, true>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <class Sub>
int by_family(int family, int local, int region, bool banded,
              const KArgs& a, cudaStream_t s) {
  if (family == 0)
    return local ? by_region<LinearPE<Sub, true>>(region, banded, a, s)
                 : by_region<LinearPE<Sub, false>>(region, banded, a, s);
  if (family == 1)
    return local ? by_region<AffinePE<Sub, true>>(region, banded, a, s)
                 : by_region<AffinePE<Sub, false>>(region, banded, a, s);
  if (family == 2 && !local)
    return by_region<TwoPiecePE<Sub>>(region, banded, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// family: 0 linear, 1 affine, 2 two-piece; matrix: substitution matrix
// scoring (else DNA match/mismatch); region: 0 corner, 1 all, 2 last row,
// 3 last row or column; band < 0: unbanded.  warps: warps per pair (1 to
// 8, at most Q / 32); ring_log2: log2 of the slots per handoff ring;
// strip_lag and ring_chunk must equal STRIP_LAG and CH.  tb may be null when with_tb is 0.  Returns the CUDA
// error code of the launch (0 on success).
int wavefront_fill_launch(
    int family, int matrix, int local, int region, int band,
    const void* query, const void* ref, const void* init_row,
    const void* init_col, const void* lens, const void* sub, int n_sub,
    int match, int mismatch, int gap, int gap_open, int gap_extend,
    int gap_open2, int gap_extend2, void* tb, void* best, void* best_j,
    int B, int Q, int R, int pack, int with_tb, int warps, int ring_log2,
    int strip_lag, int ring_chunk, void* stream) {
  if (B <= 0) return 0;
  if (bad_geometry(Q, warps, ring_log2, strip_lag, ring_chunk))
    return (int)cudaErrorInvalidValue;
  const Params p{match, mismatch, gap, gap_open, gap_extend, gap_open2,
                 gap_extend2, matrix ? n_sub : 0, 0.f, 0.f, 0.f, 0.f, 0.f,
                 0.f};
  const KArgs a = make_args(query, ref, init_row, init_col, lens, sub, p,
                            band, tb, best, best_j, B, Q, R, pack, with_tb,
                            warps, ring_log2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool banded = band >= 0;
  return matrix ? by_family<MatrixSub>(family, local, region, banded, a, s)
                : by_family<DnaSub>(family, local, region, banded, a, s);
}

}  // extern "C"
