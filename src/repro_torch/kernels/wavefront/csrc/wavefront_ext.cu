// K1 for the families beyond the gap models: DTW on complex samples (zoo
// #9, f32 min-plus) and sDTW on integer squiggles (#14, int32 min-plus),
// profile-profile alignment (#8, f32 max-plus over (5,) f32 columns), the
// 3-state Viterbi pair-HMM (#10, f32 max-plus) and the pair-HMM forward and
// backward of repro_torch/prob/kernels.py at max-plus and logsumexp.  The
// kernel itself, its mapping onto the card and what bounds it are in
// wavefront_kernel.cuh.
//
// Only the (family, objective, region, banded) combinations that a spec of
// the port reaches are instantiated; kernel.py EXT_INSTANCES lists them and
// refuses the rest before a launch.  Each cell() computes the expression of
// its plain version in core/kernels_zoo/{dtw,profile,viterbi}.py or
// prob/kernels.py in the same order; the max/min families compare with
// strict better-than as they do.  The profile's sum of pairs uses
// __fmul_rn/__fadd_rn, which nvcc never contracts into an FMA, so it
// rounds as the plain version does.

#include "wavefront_kernel.cuh"

namespace {

// complex DTW sample and profile column
struct Cplx {
  float x, y;
};
struct Prof {
  float v[5];
};

struct ComplexCost {
  using Char = Cplx;
  using Score = float;
  __device__ __forceinline__ static float cost(Cplx q, Cplx r) {
    return fabsf(q.x - r.x) + fabsf(q.y - r.y);
  }
};

struct AbsCost {
  using Char = int;
  using Score = int;
  __device__ __forceinline__ static int cost(int q, int r) {
    return abs(q - r);
  }
};

// cost + min(diag, up, left): 1 layer, pointers 1 diag, 2 up, 3 left.
template <class Cost>
struct DtwPE : Scores<typename Cost::Score, OBJ_MIN> {
  using S = typename Cost::Score;
  using Char = typename Cost::Char;
  static constexpr int L = 1;
  static constexpr unsigned UP = 0x1, DIAG = 0x1;
  static constexpr int PRIMARY = 0;
  static constexpr bool kTable = false;
  __device__ __forceinline__ static int cell(const Params&, const unsigned*,
                                             Char q, Char r, const S* diag,
                                             const S* up, const S* left,
                                             S* out) {
    const S c = Cost::cost(q, r);
    S best = diag[0];
    int ptr = 1;
    if (up[0] < best) {
      ptr = 2;
      best = up[0];
    }
    if (left[0] < best) {
      ptr = 3;
      best = left[0];
    }
    out[0] = c + best;
    return ptr;
  }
};

// Linear gaps with the sum-of-pairs score q S r of two profile columns.
struct ProfilePE : Scores<float, OBJ_MAX> {
  using Char = Prof;
  static constexpr int L = 1;
  static constexpr unsigned UP = 0x1, DIAG = 0x1;
  static constexpr int PRIMARY = 0;
  static constexpr bool kTable = true;  // the 5 x 5 f32 sub_matrix
  __device__ __forceinline__ static int cell(const Params& p,
                                             const unsigned* tab, Prof q,
                                             Prof r, const float* diag,
                                             const float* up,
                                             const float* left, float* out) {
    const float* s = reinterpret_cast<const float*>(tab);
    float sub = 0.f;
#pragma unroll
    for (int k = 0; k < 5; ++k) {  // t_k = sum_m q_m S_mk, m ascending
      float t = __fmul_rn(q.v[0], s[k]);
#pragma unroll
      for (int m = 1; m < 5; ++m) t = __fadd_rn(t, __fmul_rn(q.v[m], s[m * 5 + k]));
      sub = k == 0 ? __fmul_rn(t, r.v[0]) : __fadd_rn(sub, __fmul_rn(t, r.v[k]));
    }
    const float m = diag[0] + sub;
    const float d = up[0] + p.fgap;
    const float ins = left[0] + p.fgap;
    float best = m;
    int ptr = 1;
    if (d > best) ptr = 2;
    best = fmaxf(best, d);
    if (ins > best) ptr = 3;
    best = fmaxf(best, ins);
    out[0] = best;
    return ptr;
  }
};

// params["emission"][q, r]; codes past the table clamp to its last
// row/column.
__device__ __forceinline__ float emission(const Params& p,
                                          const unsigned* tab, int q, int r) {
  const int n = p.n_sub - 1;
  return reinterpret_cast<const float*>(tab)[min(q, n) * p.n_sub + min(r, n)];
}

template <int OBJ>
__device__ __forceinline__ float oplus(float a, float b) {
  if constexpr (OBJ == OBJ_LSE)
    return log_add_exp(a, b);
  else
    return fmaxf(a, b);
}

// Zoo #10: layers M, I, D; reads M, I, D of the diagonal, M and D above,
// M and I on the left.
struct ViterbiPE : Scores<float, OBJ_MAX> {
  using Char = uint8_t;
  static constexpr int L = 3;
  static constexpr unsigned UP = 0x5, DIAG = 0x7;
  static constexpr int PRIMARY = 0;
  static constexpr bool kTable = true;
  __device__ __forceinline__ static int cell(const Params& p,
                                             const unsigned* tab, uint8_t q,
                                             uint8_t r, const float* diag,
                                             const float* up,
                                             const float* left, float* out) {
    const float em = emission(p, tab, q, r);
    out[0] = em + fmaxf(diag[0] + p.t_mm, fmaxf(diag[1], diag[2]) + p.t_gm);
    out[1] = p.gap_emission +
             fmaxf(left[0] + p.log_lambda, left[1] + p.log_mu);
    out[2] = p.gap_emission + fmaxf(up[0] + p.log_lambda, up[2] + p.log_mu);
    return 0;
  }
};

// Pair-HMM forward, layers M, X, Y, F = M ⊕ X; reads M, X, Y of the
// diagonal, M and X above, M and Y on the left; the objective folds F.
template <int OBJ>
struct PairHmmForwardPE : Scores<float, OBJ> {
  using Char = uint8_t;
  static constexpr int L = 4;
  static constexpr unsigned UP = 0x3, DIAG = 0x7;
  static constexpr int PRIMARY = 3;
  static constexpr bool kTable = true;
  __device__ __forceinline__ static int cell(const Params& p,
                                             const unsigned* tab, uint8_t q,
                                             uint8_t r, const float* diag,
                                             const float* up,
                                             const float* left, float* out) {
    const float em = emission(p, tab, q, r);
    const float m = em + oplus<OBJ>(diag[0] + p.t_mm,
                                    oplus<OBJ>(diag[1], diag[2]) + p.t_gm);
    const float x =
        p.gap_emission + oplus<OBJ>(up[0] + p.log_lambda, up[1] + p.log_mu);
    out[0] = m;
    out[1] = x;
    out[2] = p.gap_emission +
             oplus<OBJ>(left[0] + p.log_lambda, left[2] + p.log_mu);
    out[3] = oplus<OBJ>(m, x);
    return 0;
  }
};

// Pair-HMM backward over the reversed pair, layers B_M, B_X, B_Y and the
// start mass S; reads M of the diagonal, X above, Y on the left.
template <int OBJ>
struct PairHmmBackwardPE : Scores<float, OBJ> {
  using Char = uint8_t;
  static constexpr int L = 4;
  static constexpr unsigned UP = 0x2, DIAG = 0x1;
  static constexpr int PRIMARY = 3;
  static constexpr bool kTable = true;
  __device__ __forceinline__ static int cell(const Params& p,
                                             const unsigned* tab, uint8_t q,
                                             uint8_t r, const float* diag,
                                             const float* up,
                                             const float* left, float* out) {
    const float em = emission(p, tab, q, r);
    const float open = p.log_lambda + p.gap_emission;
    const float ext = p.log_mu + p.gap_emission;
    const float from_m = p.t_mm + em + diag[0];
    const float from_gap = p.t_gm + em + diag[0];
    out[0] = oplus<OBJ>(from_m, oplus<OBJ>(open + up[1], open + left[2]));
    out[1] = oplus<OBJ>(from_gap, ext + up[1]);
    out[2] = oplus<OBJ>(from_gap, ext + left[2]);
    out[3] = from_gap;
    return 0;
  }
};

template <template <int> class PE>
int pairhmm(int objective, int region, bool banded, const KArgs& a,
            cudaStream_t s) {
  if (region != 2) return (int)cudaErrorInvalidValue;
  if (objective == OBJ_MAX)
    return banded ? launch<PE<OBJ_MAX>, 2, true>(a, s)
                  : launch<PE<OBJ_MAX>, 2, false>(a, s);
  if (objective == OBJ_LSE)
    return banded ? launch<PE<OBJ_LSE>, 2, true>(a, s)
                  : launch<PE<OBJ_LSE>, 2, false>(a, s);
  return (int)cudaErrorInvalidValue;
}

int by_family(int family, int sub, int objective, int region, bool banded,
              const KArgs& a, cudaStream_t s) {
  switch (family) {
    case 0:  // DTW: sub 0 complex (#9, corner), 1 abs (#14, last row)
      if (objective != OBJ_MIN || banded) break;
      if (sub == 0 && region == 0) return launch<DtwPE<ComplexCost>, 0, false>(a, s);
      if (sub == 1 && region == 2) return launch<DtwPE<AbsCost>, 2, false>(a, s);
      break;
    case 1:  // profile (#8)
      if (objective == OBJ_MAX && region == 0 && !banded)
        return launch<ProfilePE, 0, false>(a, s);
      break;
    case 2:  // Viterbi (#10)
      if (objective == OBJ_MAX && region == 0 && !banded)
        return launch<ViterbiPE, 0, false>(a, s);
      break;
    case 3:
      return pairhmm<PairHmmForwardPE>(objective, region, banded, a, s);
    case 4:
      return pairhmm<PairHmmBackwardPE>(objective, region, banded, a, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// family: 0 DTW, 1 profile, 2 Viterbi, 3 pair-HMM forward, 4 pair-HMM
// backward; sub: 0 complex, 1 abs (DTW only); objective: 0 max, 1 min, 2
// logsumexp; region: 0 corner, 1 all, 2 last row, 3 last row or column;
// band < 0: unbanded.  table: n_table x n_table f32 (profile sub_matrix,
// Viterbi and pair-HMM emission), null for DTW.  The score type of
// init_row, init_col and best is int32 for sDTW and f32 otherwise.  The
// other arguments are those of wavefront_fill_launch in wavefront.cu.
// Returns the CUDA error code of the launch (0 on success).
int wavefront_ext_fill_launch(
    int family, int sub, int objective, int region, int band,
    const void* query, const void* ref, const void* init_row,
    const void* init_col, const void* lens, const void* table, int n_table,
    float log_lambda, float log_mu, float t_mm, float t_gm,
    float gap_emission, float gap, void* tb, void* best, void* best_j,
    int B, int Q, int R, int pack, int with_tb, int warps, int ring_log2,
    int strip_lag, int ring_chunk, void* stream) {
  if (B <= 0) return 0;
  if (bad_geometry(Q, warps, ring_log2, strip_lag, ring_chunk))
    return (int)cudaErrorInvalidValue;
  const Params p{0, 0, 0, 0, 0, 0, 0, table ? n_table : 0,
                 log_lambda, log_mu, t_mm, t_gm, gap_emission, gap};
  const KArgs a = make_args(query, ref, init_row, init_col, lens, table, p,
                            band, tb, best, best_j, B, Q, R, pack, with_tb,
                            warps, ring_log2);
  return by_family(family, sub, objective, region, band >= 0, a,
                   static_cast<cudaStream_t>(stream));
}

}  // extern "C"
