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
// Mapping.  One lane per 64-bit word of the query: a pair with NW words
// (NW a template parameter, 1 to 16, so query buckets up to 1024) takes NW
// neighbouring lanes, and a warp, which is the whole thread block, holds
// 32 / NW pairs.  The lanes run a diagonal schedule: at step t, lane w of a
// pair advances its word by column j = t - w + 1, taking the horizontal
// delta hin that lane w - 1 produced at step t - 1 by one __shfl_up_sync
// (the lowest word takes hin0: +1 for the corner score, 0 for the search).
// VP/VN of a word stay in its lane's registers, so a column's NW word steps
// run in parallel and the dependent chain per step is one word step and one
// shuffle.  Words above the one holding row q_len (sw) idle.  The lane of
// word sw keeps the last-row score, its minimum and argmin, and writes the
// outputs.
//
// Before the sweep each lane builds its word of the match table Peq (bit t
// of symbol s is set iff query row 64 w + t holds s) from its 64 query
// bytes into shared memory, [pair][symbol][word] with one spare word per
// pair against bank conflicts, and the warp copies its pairs' reference
// codes, clamped to the table, into shared memory with zeroed slack on both
// sides; a block of 8 unrolled steps first reads its 8 reference codes
// and Peq words from shared memory, without a bounds test, so that the
// step's chain waits on no load.  A lane outside its columns keeps its
// state.
//
// The k-exit.  m(j) = min(best, score - columns left) before column j never
// falls again once it exceeds k (the score moves at most 1 a column, the
// columns left fall by 1), so the lane of word sw tests it every
// CHECK_EVERY steps, and once more after the sweep from the score and
// minimum it kept from before the last column; the outcome equals a test
// at every column.  The test's answer reaches the pair's other lanes by
// one shuffle at the same steps; the warp stops once none of its pairs is
// still running.
//
// What bounds it.  Each live word-column is a short chain of 64-bit logic
// (three-input forms fuse into one LOP3 per 32-bit half), one 64-bit add and
// two shifts by one, plus the shuffle and a few scalar operations for the
// score and the argmin, against one byte of reference code per column and
// one Peq word per word-column from shared memory: the int32 issue rate
// binds, not memory bandwidth.  What it does not do yet: a batch of 1024
// pairs of 4 words is 128 warps, about one a scheduler on a quarter of the
// card's schedulers, so a warp's time is its r_len + NW steps of the
// chain's latency rather than the issue rate; words above sw idle their
// lanes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N_SYMBOLS = 32;
constexpr int SENT = 1 << 30;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// Shared memory of one block (one warp): the Peq table, then the pairs'
// reference codes.  kernel.py smem_bytes mirrors it.
template <int NW>
__host__ __device__ constexpr size_t peq_stride() {  // uint64 per pair
  return (size_t)N_SYMBOLS * NW + 1;
}

constexpr int UNROLL = 8;      // steps a block of the sweep unrolls
// steps between tests of the k-exit; kernel.py CHECK_EVERY mirrors it
constexpr int CHECK_EVERY = 8;
static_assert(CHECK_EVERY >= 1 && CHECK_EVERY <= UNROLL &&
                  UNROLL % CHECK_EVERY == 0,
              "a block of the sweep must start with a test");
constexpr int REF_LEAD = 16;   // slack before the reference codes
constexpr int REF_TAIL = 32;   // and after them (blocks read to t_max + 7)

template <int NW>
__host__ __device__ inline size_t smem_total(int R) {
  constexpr int P = 32 / NW;
  return align16((size_t)P * peq_stride<NW>() * 8) +
         align16((size_t)P * R + REF_LEAD + REF_TAIL);
}

// reference codes clamped to the table: bytewise min with 31
__device__ __forceinline__ unsigned clamp4(unsigned v) {
  return __vminu4(v, 0x1f1f1f1fu);
}

template <int NW>
__global__ void __launch_bounds__(32) myers_kernel(
    const uint8_t* __restrict__ query, const uint8_t* __restrict__ ref,
    const int* __restrict__ lens, int* __restrict__ score_out,
    int* __restrict__ best_out, int* __restrict__ bestj_out, int B, int Q,
    int R, int glob, int k) {
  constexpr int P = 32 / NW;  // pairs per warp
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* peq_all = reinterpret_cast<uint64_t*>(smem);
  uint8_t* pad = smem + align16((size_t)P * peq_stride<NW>() * 8);
  uint8_t* refs = pad + REF_LEAD;

  const int lane = threadIdx.x;
  const int slot = lane / NW;  // the pair's place in the warp
  const int w = lane % NW;     // the word this lane owns
  const int base = slot * NW;  // the pair's lane of word 0
  const int b0 = blockIdx.x * P;
  const int b = b0 + slot;
  const bool real = b < B;
  const int q_len = real ? min(max(lens[2 * b], 0), Q) : 0;
  const int r_len = real ? min(max(lens[2 * b + 1], 0), R) : 0;
  const bool live = q_len >= 1 && r_len >= 1;
  // row q_len (the score row) sits at word sw, bit sb
  const int sw = live ? (q_len - 1) >> 6 : 0;
  const int sb = live ? (q_len - 1) & 63 : 0;

  // ---- stage: the warp's reference codes, clamped to 31 (one contiguous
  // span of P * R bytes, zeros around it), and this lane's word of Peq
  {
    const int n_pairs = min(P, B - b0);
    const uint8_t* src = ref + (size_t)b0 * R;
    const size_t n = (size_t)n_pairs * R;
    for (int t = lane; t < REF_LEAD; t += 32) pad[t] = 0;
    for (size_t t = n + lane; t < (size_t)P * R + REF_TAIL; t += 32)
      refs[t] = 0;
    if (((uintptr_t)src & 15) == 0) {
      const size_t n16 = n / 16;
      for (size_t t = lane; t < n16; t += 32) {
        uint4 v = reinterpret_cast<const uint4*>(src)[t];
        v = make_uint4(clamp4(v.x), clamp4(v.y), clamp4(v.z), clamp4(v.w));
        reinterpret_cast<uint4*>(refs)[t] = v;
      }
      for (size_t t = n16 * 16 + lane; t < n; t += 32)
        refs[t] = min((unsigned)src[t], N_SYMBOLS - 1u);
    } else {
      for (size_t t = lane; t < n; t += 32)
        refs[t] = min((unsigned)src[t], N_SYMBOLS - 1u);
    }
  }
  uint64_t* peq = peq_all + slot * peq_stride<NW>();
#pragma unroll
  for (int s = 0; s < N_SYMBOLS; ++s) peq[s * NW + w] = 0;
  if (live && w <= sw) {
    // rows past q_len and codes past the table match nothing
    const uint8_t* qb = query + (size_t)b * Q + 64 * w;
    const int n_rows = min(q_len - 64 * w, 64);
    if (n_rows == 64 && ((uintptr_t)qb & 15) == 0) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const uint4 x = reinterpret_cast<const uint4*>(qb)[v];
        const unsigned part[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int h = 0; h < 16; ++h) {
          const unsigned c = (part[h >> 2] >> (8 * (h & 3))) & 0xffu;
          if (c < N_SYMBOLS) peq[c * NW + w] |= 1ull << (16 * v + h);
        }
      }
    } else {
      for (int i = 0; i < n_rows; ++i) {
        const unsigned c = qb[i];
        if (c < N_SYMBOLS) peq[c * NW + w] |= 1ull << i;
      }
    }
  }
  __syncwarp();

  // lane w advances column j = t - w + 1 at steps t in [w, t_hi]; the
  // pair's last step is that of word sw, t_end
  const uint8_t* rcol = refs + (size_t)slot * R - w;  // rcol[t]: column j's code
  // the horizontal delta between words travels as two bits: +1 in bit 0,
  // -1 in bit 1
  const int hin0 = glob ? 1 : 0;
  const uint64_t sbit = 1ull << sb;
  uint64_t vp = ~0ull, vn = 0;
  int score = q_len, best = SENT, bestj = 0;
  int s_prev = score, b_prev = best;  // before the column last advanced
  bool stopped = false;  // the k-exit fired (decided by the lane of sw)
  bool dead = !live;
  int t_hi = (live && w <= sw) ? r_len - 1 + w : -1;
  const int t_end = live ? r_len - 1 + sw : -1;
  int t_max = t_end;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    t_max = max(t_max, __shfl_xor_sync(FULL, t_max, off));

  int hout = 0;
  // the k-exit, tested by the lane of word sw before its column of step t
  // and sent to the pair's lanes; false once no pair of the warp runs
  auto test = [&](int t) -> bool {
    const int j = t - w + 1;
    if (w == sw && t >= w && t <= t_hi && k >= 0 &&
        min(best, score - (r_len - (j - 1))) > k)
      stopped = true;
    if (__shfl_sync(FULL, (int)stopped, base + sw)) {
      dead = true;
      t_hi = -1;
    }
    return __any_sync(FULL, !dead && t <= t_end);
  };
  auto step = [&](int t, uint64_t eq0) {
    const int from_below = __shfl_up_sync(FULL, hout, 1);
    const unsigned hin = w == 0 ? hin0 : from_below;
    if (t >= w && t <= t_hi) {
      const uint64_t hneg = hin >> 1;
      const uint64_t hpos = hin & 1u;
      const uint64_t xv = eq0 | vn;
      const uint64_t eq = eq0 | hneg;
      const uint64_t xh = (((eq & vp) + vp) ^ vp) | eq;
      const uint64_t ph = vn | ~(xh | vp);
      const uint64_t mh = vp & xh;
      hout = (int)(ph >> 63) | ((int)(mh >> 63) << 1);
      const uint64_t phs = (ph << 1) | hpos;
      const uint64_t mhs = (mh << 1) | hneg;
      vp = mhs | ~(xv | phs);
      vn = phs & xv;
      // the last-row score (meaningful in the lane of word sw only)
      s_prev = score;
      b_prev = best;
      score += (int)((ph & sbit) != 0) - (int)((mh & sbit) != 0);
      if (!glob && score < best) {  // strict: the first argmin column wins
        best = score;
        bestj = t - w + 1;
      }
    }
  };
  // steps in blocks of UNROLL, tests every CHECK_EVERY steps; steps past
  // t_max advance no lane (t > t_hi) and read the zeroed slack of refs.
  // A block loads its UNROLL Peq words first, so that their shared-memory
  // latency is paid once a block and not on every step's chain.
  for (int t0 = 0; t0 <= t_max; t0 += UNROLL) {
    uint64_t eqs[UNROLL];
#pragma unroll
    for (int d = 0; d < UNROLL; ++d) eqs[d] = peq[rcol[t0 + d] * NW + w];
    bool more = true;
#pragma unroll
    for (int d = 0; d < UNROLL; ++d) {
      if (d % CHECK_EVERY == 0 && !test(t0 + d)) {
        more = false;
        break;
      }
      step(t0 + d, eqs[d]);
    }
    if (!more) break;
  }
  // the last column is always tested: min(best, score - 1) before it
  if (w == sw && live && !stopped && k >= 0 && min(b_prev, s_prev - 1) > k)
    stopped = true;
  if (real && w == sw) {
    const bool out_dead = !live || stopped;
    score_out[b] = out_dead ? SENT : score;
    best_out[b] = out_dead ? SENT : best;
    bestj_out[b] = out_dead ? 0 : bestj;
  }
}

template <int NW>
int launch(const void* query, const void* ref, const void* lens, void* score,
           void* best, void* best_j, int B, int Q, int R, int glob, int k,
           cudaStream_t stream) {
  auto kern = myers_kernel<NW>;
  const size_t smem = smem_total<NW>(R);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int P = 32 / NW;
  const int grid = (B + P - 1) / P;
  kern<<<grid, 32, smem, stream>>>(
      static_cast<const uint8_t*>(query), static_cast<const uint8_t*>(ref),
      static_cast<const int*>(lens), static_cast<int*>(score),
      static_cast<int*>(best), static_cast<int*>(best_j), B, Q, R, glob, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// n_words: 64-bit words per column (1, 2, 4, 8 or 16, at least Q / 64);
// glob: 1 for the corner score (edit_distance), 0 for the last-row search
// (edit_search); k < 0: no threshold.  Returns the CUDA error code of the
// launch (0 on success).
int myers_fill_launch(int n_words, int glob, int k,
                      const void* query, const void* ref, const void* lens,
                      void* score, void* best, void* best_j, int B, int Q,
                      int R, void* stream) {
  if (B <= 0) return 0;
  if (Q > 64 * n_words) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_words) {
    case 1: return launch<1>(query, ref, lens, score, best, best_j, B, Q, R, glob, k, s);
    case 2: return launch<2>(query, ref, lens, score, best, best_j, B, Q, R, glob, k, s);
    case 4: return launch<4>(query, ref, lens, score, best, best_j, B, Q, R, glob, k, s);
    case 8: return launch<8>(query, ref, lens, score, best, best_j, B, Q, R, glob, k, s);
    case 16: return launch<16>(query, ref, lens, score, best, best_j, B, Q, R, glob, k, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
