// K2 on Hopper: Myers/Hyyro blocked bit-vector unit-cost edit distance.
//
// Replaces the Pallas TPU kernel src/repro/kernels/myers/kernel.py, function
// myers_fill (body _kernel_body, word step _advance_scalar), and computes
// what it computes: per pair the corner score (edit_distance) or the
// last-row minimum with its first column (edit_search).  The Pallas wrapper
// gathers the per-column match words in XLA (ops.py) and the kernel always
// runs to r_len; here the kernel builds its own match table and takes the
// provable-k exit of core/myers.py: a pair stops once
// min(best, score - columns left) > k, and then reports the sentinel.
//
// Mapping.  One thread owns one pair; 128 threads per block, the grid is the
// batch (JAX vmaps the per-pair kernel).  A column of the DP matrix is NW
// 64-bit words of VP/VN held in registers (NW a template parameter, 1 to
// 16, so query buckets up to 1024).  The word loop is unrolled; words couple
// only through the scalar horizontal delta hin/hout at their boundary row,
// and words above the one holding row q_len are skipped, since nothing
// flows down from them.  The match table Peq (32 symbols x NW words) is
// built by the thread into a device scratch table laid out
// [symbol][word][pair], so that the threads of a warp reading the same
// symbol read neighbouring words; the column loop reads row peq[ref[j]].
//
// What bounds it.  Each live word-column is a short chain of 64-bit logic
// (three-input forms fuse into one LOP3 per 32-bit half), one 64-bit add and
// two shifts by one, plus a few scalar operations per column for the score
// and the argmin, against one byte of reference code per column and one Peq
// word per word-column, mostly from L1 and L2: the int32 issue rate binds,
// not memory bandwidth.  What it does not do yet: occupancy.  One
// thread per pair gives 8 blocks at a 1024-pair batch on 132 SMs; the first
// later change is more pairs per block in flight, or a warp per long pair
// with hin passed between lanes by shuffle, and the Peq table in shared
// memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N_SYMBOLS = 32;
constexpr int SENT = 1 << 30;
constexpr int THREADS = 128;

template <int NW>
__global__ void __launch_bounds__(THREADS) myers_kernel(
    const uint8_t* __restrict__ query, const uint8_t* __restrict__ ref,
    const int* __restrict__ lens, uint64_t* __restrict__ peq,
    int* __restrict__ score_out, int* __restrict__ best_out,
    int* __restrict__ bestj_out, int B, int Q, int R, int glob, int k) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  const int q_len = min(max(lens[2 * b], 0), Q);
  const int r_len = min(max(lens[2 * b + 1], 0), R);
  if (q_len < 1 || r_len < 1) {
    score_out[b] = SENT;
    best_out[b] = SENT;
    bestj_out[b] = 0;
    return;
  }
  // row q_len (the score row) sits at word sw, bit sb
  const int sw = (q_len - 1) >> 6;
  const int sb = (q_len - 1) & 63;

  // Peq: bit t of word w of symbol s is set iff query row 64 w + t holds s;
  // rows past q_len and codes past the table match nothing
  const uint8_t* qb = query + (size_t)b * Q;
  for (int w = 0; w <= sw; ++w) {
    uint64_t acc[N_SYMBOLS];
#pragma unroll
    for (int s = 0; s < N_SYMBOLS; ++s) acc[s] = 0;
    const int lo = w * 64, hi = min(q_len, lo + 64);
    for (int i = lo; i < hi; ++i) {
      const int c = qb[i];
      if (c < N_SYMBOLS) acc[c] |= 1ull << (i - lo);
    }
#pragma unroll
    for (int s = 0; s < N_SYMBOLS; ++s)
      peq[((size_t)s * NW + w) * B + b] = acc[s];
  }

  uint64_t vp[NW], vn[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    vp[w] = ~0ull;
    vn[w] = 0;
  }
  const uint8_t* rb = ref + (size_t)b * R;
  const int hin0 = glob ? 1 : 0;
  int score = q_len, best = SENT, bestj = 0;
  int j = 1;
  for (; j <= r_len; ++j) {
    // most optimistic finish: the last-row score moves <= 1 per column
    if (k >= 0 && min(best, score - (r_len - (j - 1))) > k) break;
    const int c = min((int)rb[j - 1], N_SYMBOLS - 1);
    const uint64_t* eq_row = peq + (size_t)c * NW * B + b;
    int hin = hin0;
    int inc = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      if (w <= sw) {
        const uint64_t hneg = hin < 0 ? 1ull : 0ull;
        const uint64_t hpos = hin > 0 ? 1ull : 0ull;
        uint64_t eq = eq_row[(size_t)w * B];
        const uint64_t xv = eq | vn[w];
        eq |= hneg;
        const uint64_t xh = (((eq & vp[w]) + vp[w]) ^ vp[w]) | eq;
        const uint64_t ph = vn[w] | ~(xh | vp[w]);
        const uint64_t mh = vp[w] & xh;
        hin = (int)(ph >> 63) - (int)(mh >> 63);
        if (w == sw) inc = (int)((ph >> sb) & 1ull) - (int)((mh >> sb) & 1ull);
        const uint64_t phs = (ph << 1) | hpos;
        const uint64_t mhs = (mh << 1) | hneg;
        vp[w] = mhs | ~(xv | phs);
        vn[w] = phs & xv;
      }
    }
    score += inc;
    if (!glob && score < best) {  // strict: the first argmin column wins
      best = score;
      bestj = j;
    }
  }
  if (j <= r_len) {  // stopped early: the distance provably exceeds k
    score = SENT;
    best = SENT;
    bestj = 0;
  }
  score_out[b] = score;
  best_out[b] = best;
  bestj_out[b] = bestj;
}

template <int NW>
int launch(const void* query, const void* ref, const void* lens, void* peq,
           void* score, void* best, void* best_j, int B, int Q, int R,
           int glob, int k, cudaStream_t stream) {
  const int grid = (B + THREADS - 1) / THREADS;
  myers_kernel<NW><<<grid, THREADS, 0, stream>>>(
      static_cast<const uint8_t*>(query), static_cast<const uint8_t*>(ref),
      static_cast<const int*>(lens), static_cast<uint64_t*>(peq),
      static_cast<int*>(score), static_cast<int*>(best),
      static_cast<int*>(best_j), B, Q, R, glob, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// n_words: 64-bit words per column (1, 2, 4, 8 or 16, at least Q / 64);
// peq: scratch of N_SYMBOLS * n_words * B uint64; glob: 1 for the corner
// score (edit_distance), 0 for the last-row search (edit_search); k < 0:
// no threshold.  Returns the CUDA error code of the launch (0 on success).
int myers_fill_launch(int n_words, int glob, int k, const void* query,
                      const void* ref, const void* lens, void* peq,
                      void* score, void* best, void* best_j, int B, int Q,
                      int R, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_words) {
    case 1: return launch<1>(query, ref, lens, peq, score, best, best_j, B, Q, R, glob, k, s);
    case 2: return launch<2>(query, ref, lens, peq, score, best, best_j, B, Q, R, glob, k, s);
    case 4: return launch<4>(query, ref, lens, peq, score, best, best_j, B, Q, R, glob, k, s);
    case 8: return launch<8>(query, ref, lens, peq, score, best, best_j, B, Q, R, glob, k, s);
    case 16: return launch<16>(query, ref, lens, peq, score, best, best_j, B, Q, R, glob, k, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
