// K1 on Hopper: the anti-diagonal DP matrix fill with a bit-packed
// traceback store, generic in the PE functor.
//
// Replaces the Pallas TPU kernel src/repro/kernels/wavefront/kernel.py,
// function wavefront_fill (body _kernel_body), and computes exactly what it
// computes: per (pair, strip, lane) the running best score over the
// objective region and its first column (or, under a sum semiring, the
// region mass folded with logaddexp), and the ('chunk', 32, pack) pointer
// store tb[pair][strip][lane / pack][w], w = lane + j - 1.  The one
// difference is deliberate: the init row and column arrive already masked
// by effective length and band (as core/reference.py masks them), where the
// Pallas kernel loads them unmasked.
//
// Two translation units include this header and instantiate the kernel on
// their PE functors: wavefront.cu the int32 max-plus gap-model families
// (linear, affine, two-piece), wavefront_ext.cu DTW/sDTW (min-plus),
// profile, Viterbi and the pair-HMM forward and backward (f32 max-plus and
// logsumexp).  Every other spec's PE is lowered from its torch graph by
// kernels/wavefront/synth.py into a translation unit of its own under
// build/repro_torch/gen/, which includes this header the same way.  A PE
// functor declares
//   Score     int or float, the score type of every layer;
//   Char      the staged character type (uint8_t codes, int samples, or a
//             struct of floats);
//   kObj      OBJ_MAX / OBJ_MIN (strict better-than keeps the first
//             column) or OBJ_LSE (the region mass is folded with
//             log_add_exp, best_j is unused);
//   sent()    the unreachable score (-2^30 / +2^30 for int, -1e30 / +1e30
//             for float, the sign by the objective);
//   L, PRIMARY the layer count and the layer the objective reads;
//   UP, DIAG  masks of the layers it reads from the cell above and the
//             diagonal cell;
//   kTable    whether it reads the substitution / emission table;
//   cell(p, tab, q, r, diag, up, left, out) -> pointer.
// and may declare (the hand-written functors declare neither)
//   kSlots    true: cell's p is the launch's Slots block (the scalar
//             parameters of a generated PE), not Params, and the table
//             holds Slots::n_words 32-bit words;
//   kIJ       true: cell also takes the cell's 1-based (i, j), as the
//             plain sweep passes them to the PE.
//
// Mapping.  One thread block fills one pair with G warps for its C
// strips of 32 rows (G up to 8, fewer when the batch would overfill the
// card: kernel.py strip_warps); warp g takes strips g, g + G, ...; lane l
// is the PE of row i = 32 c + l + 1 of strip c and visits the cell (i, j)
// at wavefront w = l + j - 1.  The strips run as a pipeline: strip c + 1
// needs strip c's bottom row, which strip c's lane 31 finishes column by
// column, column x at wavefront x + 30, so strip c + 1 trails strip c by
// at least STRIP_LAG = 32 wavefronts (kernel.py exports the same constant
// and the launch checks it).  The row passes between the two warps through
// a ring of NCH chunks of CH = 16 columns in shared memory, one ring per
// strip boundary, guarded by an mbarrier pair per slot: the producer
// arrives on "full" once the chunk's last column is written (after
// wavefront CH (k + 1) + STRIP_LAG - 2), the consumer waits on it before
// it first reads the chunk and arrives on "empty" after its last read, and
// the producer waits on "empty" before it reuses a slot.  A strip runs in
// blocks of CH wavefronts aligned to that handoff: in block m lane 0 reads
// chunk m of the row above, one wavefront ahead of its use, and lane 31
// writes chunk m - 2 of its own bottom row, so the waits and signals sit
// between blocks and not in the per-wavefront loop.  A warp takes its
// strips in order, so the strip on the warp that would consume the last
// live strip's row may still be busy with an earlier strip; NCH >=
// ceil(chunks / G) + 1 slots let every producer run far enough for the
// ring never to close on itself (the argument is in kernel.py,
// ring_chunks; tests/test_torch_wavefront.py replays the protocol).
//
// Per wavefront a lane shuffles only the score layers its PE reads from
// the cell above or the diagonal (SH = UP | DIAG: H for the linear and DTW
// families, H and D for affine, M, X and Y for the pair-HMM forward); the
// diagonal neighbour is what it received one wavefront earlier, and column
// 0 comes from the init column.  The pair's reference and query characters
// and the init row's SH layers are staged in shared memory once
// (cp.async for byte codes), so the wavefront loop reads nothing from
// device memory: each lane reads its own reference character ref[w - l].
// Each lane's valid wavefronts (j in [1, r_len], inside the band, its row
// live) are one interval computed before the loop.  Pointers go to a
// 32-wavefront tile per warp in shared memory, one byte per lane; every 32
// wavefronts each lane packs one wavefront's bytes from 8 words and the
// warp writes each lane-byte row of the strip as 32 contiguous bytes.  The
// kernel writes every byte of the store, zeros for skipped wavefronts, dead
// strips and out-of-band cells, so the wrapper allocates it uninitialised.
// A banded strip visits only the wavefronts that hold a cell with
// |i - j| <= band in one of its rows.
//
// What bounds it.  Each cell of the integer families costs a handful of
// int32 ALU operations per score layer (adds, maxes, compares, selects)
// plus the shuffles, the tile byte and the best update, so the int32 issue
// rate binds before memory bandwidth at every bucket size; the logsumexp
// pair-HMM spends five logaddexps a cell, each one exp and one log1p on
// the special-function units (expf and log1pf, not the fast-math
// intrinsics).  A warp alone issues a wavefront's few dozen dependent
// instructions at a handful of cycles each, so the card needs many warps
// resident to reach that rate.  What it does not do yet: the rows of the
// store are 32 + R - 1 bytes long, odd for even R, so a lane-byte row is
// not 16-byte aligned and the tile goes out as byte stores that the warp
// coalesces 32 at a time; the pipeline's fill and drain leave each warp
// idle for about (G - 1) x 47 of a pair's wavefronts.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int N_PE = 32;
constexpr int STRIP_LAG = 32;   // mirrors kernel.py STRIP_LAG
constexpr int CH = 16;          // columns per handoff chunk
constexpr int MAX_WARPS = 8;    // warps per pair (block)
constexpr int TILE_STRIDE = 36; // bytes per wavefront in the pointer tile
constexpr int REF_PAD = 32;     // slack characters on each side of the ref
// A block of CH wavefronts ends exactly where the chunk it writes is
// complete, CH (k + 1) + STRIP_LAG - 2, when the lag is two chunks.
static_assert(STRIP_LAG == 2 * CH, "the block grid assumes STRIP_LAG == 2 CH");
static_assert(N_PE % CH == 0 && (CH & (CH - 1)) == 0, "CH: a power of 2");
constexpr unsigned FULL = 0xffffffffu;

// objectives (kernel.py OBJECTIVE_IDS)
constexpr int OBJ_MAX = 0;
constexpr int OBJ_MIN = 1;
constexpr int OBJ_LSE = 2;

__host__ __device__ constexpr int popc(unsigned v) {
  return v ? (int)(v & 1u) + popc(v >> 1) : 0;
}

// Every scoring parameter a PE may read: the gap-model families' ints and
// the pair-HMM / profile floats; n_sub is the side of the table (0: none).
struct Params {
  int match, mismatch, gap, gap_open, gap_extend, gap_open2, gap_extend2;
  int n_sub;
  float log_lambda, log_mu, t_mm, t_gm, gap_emission, fgap;
};

// The scalar parameters of a generated PE (synth.py MAX_SLOTS): each an
// int64 value or the bits of a float or double; n_words: 32-bit words of
// its tables (0: none).
constexpr int MAX_SLOTS = 32;
struct Slots {
  long long s[MAX_SLOTS];
  int n_words;
};

// The optional functor members kSlots and kIJ (false when not declared).
template <class PE, class = void>
struct HasSlots : std::false_type {};
template <class PE>
struct HasSlots<PE, std::void_t<decltype(PE::kSlots)>>
    : std::integral_constant<bool, PE::kSlots> {};
template <class PE, class = void>
struct HasIJ : std::false_type {};
template <class PE>
struct HasIJ<PE, std::void_t<decltype(PE::kIJ)>>
    : std::integral_constant<bool, PE::kIJ> {};

template <class S> struct Far;
template <> struct Far<int> {
  __host__ __device__ static constexpr int value() { return 1 << 30; }
};
template <> struct Far<float> {
  __host__ __device__ static constexpr float value() { return 1e30f; }
};

// The score type and objective of a PE functor.
template <class S, int OBJ>
struct Scores {
  using Score = S;
  static constexpr int kObj = OBJ;
  __host__ __device__ static constexpr S sent() {
    return OBJ == OBJ_MIN ? Far<S>::value() : -Far<S>::value();
  }
};

// logaddexp that absorbs the sentinel exactly: logaddexp(-1e30, x) == x and
// logaddexp(-1e30, -1e30) == -1e30 (ulp(1e30) ~ 8e22), no inf - inf.
__device__ __forceinline__ float log_add_exp(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

// Objective regions: 0 corner, 1 all, 2 last row, 3 last row or column.
template <int REGION>
__device__ __forceinline__ bool region_sel(int i, int j, int q_len,
                                           int r_len) {
  if (REGION == 0) return i == q_len && j == r_len;
  if (REGION == 1) return true;
  if (REGION == 2) return i == q_len;
  return i == q_len || j == r_len;
}

// ---- shared-memory layout of one block (kernel.py smem_bytes mirrors it)
__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

struct Layout {
  size_t bar, sub, ring, irow, tile, qry, ref, total;
};

// sub_words: 4-byte words of the table; nu: layers a ring carries;
// csize: bytes of one character.
__host__ __device__ inline Layout layout(int sub_words, int G, int nch,
                                         int nu, int Q, int R, int with_tb,
                                         int csize) {
  Layout s;
  size_t o = 0;
  s.bar = o;
  o += align16((size_t)G * nch * 2 * sizeof(uint64_t));
  s.sub = o;
  o += align16((size_t)sub_words * 4);
  s.ring = o;
  o += align16((size_t)G * nch * CH * nu * 4);
  s.irow = o;
  o += align16((size_t)(R + 1) * nu * 4);
  s.tile = o;
  o += with_tb ? (size_t)G * N_PE * TILE_STRIDE : 0;
  s.qry = o;
  o += align16((size_t)Q * csize);
  s.ref = o;
  o += align16((size_t)(R + 2 * REF_PAD) * csize);
  s.total = o;
  return s;
}

// ---- mbarrier and cp.async helpers (PTX, sm_90)
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}" ::"r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(unsigned addr,
                                              unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(ok)
      : "r"(addr), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait for the completion of phase `n` (0, 1, 2, ...) of `bar`.  A wait
// that lasts seconds can only be a broken protocol: trap, so that the
// launch fails instead of hanging the device.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int n) {
  const unsigned addr = smem_addr(bar);
  const unsigned parity = (unsigned)n & 1u;
  if (mbar_try_wait(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(addr, parity)) {
    if (clock64() - t0 > (1ll << 33)) __trap();
  }
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::
                   : "memory");
}

// n bytes of zeros from one warp: 16-byte stores on the aligned middle.
__device__ void warp_zero(uint8_t* p, size_t n, int lane) {
  size_t head = (16 - ((uintptr_t)p & 15)) & 15;
  if (head > n) head = n;
  for (size_t t = lane; t < head; t += N_PE) p[t] = 0;
  const size_t n16 = (n - head) / 16;
  uint4* v = reinterpret_cast<uint4*>(p + head);
  for (size_t t = lane; t < n16; t += N_PE) v[t] = make_uint4(0, 0, 0, 0);
  for (size_t t = head + n16 * 16 + lane; t < n; t += N_PE) p[t] = 0;
}

// Pack tile T of a warp's pointer tile (one byte per lane and wavefront:
// wavefront w's 32 lane-bytes at row (w + 1) & 31, TILE_STRIDE bytes a
// row) into the strip's store.  Tile T holds wavefronts 32 T - 1 ...
// 32 T + 30; lane t takes wavefront 32 T - 1 + t, reads its 32 lane-bytes
// as 8 words, and writes byte lb of it to lane-byte row lb (the pointers of
// lanes lb * PACK ... lb * PACK + PACK - 1 in slots of 8 / PACK bits): each
// row gets 32 contiguous bytes a tile.  Wavefronts outside [w_lo, w_hi)
// are written as zeros.
template <int PACK>
__device__ __forceinline__ void flush_tile(uint8_t* tbs, const uint8_t* tile,
                                           int T, int WT, int w_lo, int w_hi,
                                           int lane) {
  constexpr int LB = N_PE / PACK, WIDTH = 8 / PACK;
  constexpr unsigned MASK = (1u << WIDTH) - 1u;
  const int ww = T * 32 - 1 + lane;
  if (ww < 0 || ww >= WT) return;
  unsigned word[N_PE / 4];
#pragma unroll
  for (int k = 0; k < N_PE / 4; ++k)
    word[k] = (ww >= w_lo && ww < w_hi)
                  ? reinterpret_cast<const unsigned*>(
                        tile + lane * TILE_STRIDE)[k]
                  : 0u;
#pragma unroll
  for (int lb = 0; lb < LB; ++lb) {
    unsigned v = 0;
#pragma unroll
    for (int s = 0; s < PACK; ++s) {
      const int l = lb * PACK + s;
      v |= ((word[l >> 2] >> ((l & 3) * 8)) & MASK) << (s * WIDTH);
    }
    tbs[(size_t)lb * WT + ww] = (uint8_t)v;
  }
}

__device__ __forceinline__ void flush_tile(int pack, uint8_t* tbs,
                                           const uint8_t* tile, int T, int WT,
                                           int w_lo, int w_hi, int lane) {
  switch (pack) {
    case 1: flush_tile<1>(tbs, tile, T, WT, w_lo, w_hi, lane); break;
    case 2: flush_tile<2>(tbs, tile, T, WT, w_lo, w_hi, lane); break;
    case 4: flush_tile<4>(tbs, tile, T, WT, w_lo, w_hi, lane); break;
    default: flush_tile<8>(tbs, tile, T, WT, w_lo, w_hi, lane); break;
  }
}

// Device pointers of one launch; the score type of init_row, init_col and
// best, the character type of query and ref and the word type of sub are
// the PE's.
struct KArgs {
  const void* query;
  const void* ref;
  const void* init_row;
  const void* init_col;
  const int* lens;
  const void* sub;
  Params p;
  int band;
  uint8_t* tb;
  void* best;
  int* best_j;
  int B, Q, R, pack, with_tb, G, nch_log2;
  Slots g;  // a generated PE's scalar parameters (unused by the others)
};

// A functor's cell() as it declares it: the hand-written ones take Params,
// a generated one (kSlots) the Slots block, and a kIJ functor also the
// cell's 1-based (i, j).  (One struct per form, so that the hand-written
// functors' call compiles as it did before the others existed.)
template <class PE, bool SLOTS = HasSlots<PE>::value,
          bool IJ = HasIJ<PE>::value>
struct CellCall {
  template <class A, class Ch, class S>
  __device__ __forceinline__ static int run(const A& a, const unsigned* tab,
                                            Ch q, Ch r, const S* diag,
                                            const S* up, const S* left,
                                            S* out, int, int) {
    return PE::cell(a.p, tab, q, r, diag, up, left, out);
  }
};
template <class PE>
struct CellCall<PE, false, true> {
  template <class A, class Ch, class S>
  __device__ __forceinline__ static int run(const A& a, const unsigned* tab,
                                            Ch q, Ch r, const S* diag,
                                            const S* up, const S* left,
                                            S* out, int i, int j) {
    return PE::cell(a.p, tab, q, r, diag, up, left, out, i, j);
  }
};
template <class PE, bool IJ>
struct CellCall<PE, true, IJ> {
  template <class A, class Ch, class S>
  __device__ __forceinline__ static int run(const A& a, const unsigned* tab,
                                            Ch q, Ch r, const S* diag,
                                            const S* up, const S* left,
                                            S* out, int i, int j) {
    if constexpr (IJ)
      return PE::cell(a.g, tab, q, r, diag, up, left, out, i, j);
    else
      return PE::cell(a.g, tab, q, r, diag, up, left, out);
  }
};

// The handoff ring one strip boundary carries: NK chunks of CH columns
// through 1 << nch_log2 slots, chunk n (counted over the pairs' strips that
// use this boundary) in slot n % NCH, phase n / NCH of its barriers.
template <class S>
struct Ring {
  S* data;         // NCH x CH x NU scores
  uint64_t* bars;  // per slot: full, empty
  int seq;         // chunk count before this strip's first chunk
  int log2;
  __device__ int slot(int k) const { return (seq + k) & ((1 << log2) - 1); }
  __device__ int phase(int k) const { return (seq + k) >> log2; }
  __device__ uint64_t* full(int k) const { return bars + 2 * slot(k); }
  __device__ uint64_t* empty(int k) const { return bars + 2 * slot(k) + 1; }
};

// Fold one region cell into a lane's best: strict better-than for the
// selective objectives (the first column wins a tie), logaddexp for the
// sum semiring (best_j unused).
template <class PE>
__device__ __forceinline__ void fold(typename PE::Score v, int j,
                                     typename PE::Score& best, int& bestj) {
  if constexpr (PE::kObj == OBJ_LSE) {
    best = log_add_exp(best, v);
  } else if constexpr (PE::kObj == OBJ_MIN) {
    if (v < best) {
      best = v;
      bestj = j;
    }
  } else {
    if (v > best) {
      best = v;
      bestj = j;
    }
  }
}

template <class PE, int REGION, bool BANDED>
__global__ void __launch_bounds__(MAX_WARPS * N_PE)
    wavefront_kernel(const KArgs a) {
  using S = typename PE::Score;
  using Ch = typename PE::Char;
  constexpr int L = PE::L;
  constexpr unsigned DG = PE::DIAG;
  constexpr unsigned SH = PE::UP | PE::DIAG;  // carried from the row above
  constexpr int NU = popc(SH);
  constexpr int P = PE::PRIMARY;
  constexpr S SENT = PE::sent();
  extern __shared__ __align__(16) unsigned char smem[];
  const int Q = a.Q, R = a.R, G = a.G, NCH = 1 << a.nch_log2;
  const int sub_words = !PE::kTable ? 0
                        : HasSlots<PE>::value ? a.g.n_words
                                              : a.p.n_sub * a.p.n_sub;
  const Layout lay =
      layout(sub_words, G, NCH, NU, Q, R, a.with_tb, (int)sizeof(Ch));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bar);
  unsigned* tab = reinterpret_cast<unsigned*>(smem + lay.sub);
  S* rings = reinterpret_cast<S*>(smem + lay.ring);
  S* irow = reinterpret_cast<S*>(smem + lay.irow);
  uint8_t* tiles = smem + lay.tile;
  Ch* sq = reinterpret_cast<Ch*>(smem + lay.qry);
  Ch* sr = reinterpret_cast<Ch*>(smem + lay.ref) + REF_PAD;  // [-PAD, R+PAD)

  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int C = Q / N_PE;
  const int WT = N_PE + R - 1;
  const int LB = N_PE / a.pack;
  const int q_len = a.lens[2 * b];
  const int r_len = a.lens[2 * b + 1];

  // ---- stage the pair's characters, the init row's SH layers, the table
  const Ch* qb = static_cast<const Ch*>(a.query) + (size_t)b * Q;
  const Ch* rb = static_cast<const Ch*>(a.ref) + (size_t)b * R;
  const S* irow_g = static_cast<const S*>(a.init_row) + (size_t)b * (R + 1) * L;
  const S* icol = static_cast<const S*>(a.init_col) + (size_t)b * (Q + 1) * L;
  if (sizeof(Ch) == 1 && ((uintptr_t)qb & 15) == 0) {
    for (int t = threadIdx.x; t < Q / 16; t += blockDim.x)
      cp_async16(reinterpret_cast<uint8_t*>(sq) + 16 * t,
                 reinterpret_cast<const uint8_t*>(qb) + 16 * t);
  } else {
    for (int t = threadIdx.x; t < Q; t += blockDim.x) sq[t] = qb[t];
  }
  for (int t = threadIdx.x; t < (R + 1) * NU; t += blockDim.x) {
    const int x = t / NU, u = t % NU;
    int l = 0;  // the u-th set bit of SH
    for (int k = 0, seen = 0; k < L; ++k)
      if ((SH >> k) & 1u) {
        if (seen == u) l = k;
        ++seen;
      }
    cp_async4(irow + t, irow_g + x * L + l);
  }
  // reference characters with REF_PAD of slack on each side, so that lane
  // l reads ref[w - l] unclamped (the cells past either end are invalid)
  for (int t = threadIdx.x - REF_PAD; t < R + REF_PAD; t += blockDim.x)
    sr[t] = (t >= 0 && t < R) ? rb[t] : Ch{};
  for (int t = threadIdx.x; t < sub_words; t += blockDim.x)
    tab[t] = static_cast<const unsigned*>(a.sub)[t];
  if (threadIdx.x == 0)
    for (int t = 0; t < G * NCH * 2; ++t) mbar_init(bars + t, 1);
  cp_async_wait_all();
  __syncthreads();

  const int rl = max(min(r_len, R), 0);
  const int NK = (rl + CH - 1) / CH;  // chunks a boundary carries
  const int n_w = min(WT, max(r_len + N_PE - 1, 0));
  const int n_live = q_len <= 0 ? 0 : min(C, (q_len + N_PE - 1) / N_PE);
  uint8_t* tile = tiles + warp * N_PE * TILE_STRIDE;
  const int NT = (WT + 32) / 32;  // tiles cover wavefronts -1 .. 32 NT - 2

  for (int c = warp; c < C; c += G) {
    S* bo = static_cast<S*>(a.best) + ((size_t)b * C + c) * N_PE;
    int* bjo = a.best_j + ((size_t)b * C + c) * N_PE;
    uint8_t* tbs = a.with_tb ? a.tb + ((size_t)b * C + c) * LB * WT : nullptr;
    if (c >= n_live) {  // every row of this strip is invalid
      if (a.with_tb) warp_zero(tbs, (size_t)LB * WT, lane);
      bo[lane] = SENT;
      bjo[lane] = 0;
      continue;
    }
    // the ring this strip reads (from strip c - 1) and the one it writes
    const bool consume = c > 0;
    const bool produce = c + 1 < n_live;
    const int gin = (c - 1 + G) % G, gout = c % G;
    const int ring_len = CH * NU << a.nch_log2;
    const Ring<S> in_r{rings + gin * ring_len, bars + gin * NCH * 2,
                       consume ? ((c - 1) / G) * NK : 0, a.nch_log2};
    const Ring<S> out_r{rings + gout * ring_len, bars + gout * NCH * 2,
                        (c / G) * NK, a.nch_log2};

    // the wavefronts this strip visits; one before the first live one, so
    // that lane 0 carries that column's row-above layers as the diagonal
    // of the next
    int w_lo = 0, w_end = n_w;
    if (BANDED) {
      const int l_max = min(N_PE - 1, q_len - c * N_PE - 1);
      w_lo = max(0, c * N_PE - a.band);
      w_end = min(n_w, c * N_PE + 2 * l_max + a.band + 1);
    }
    const int w_start = max(w_lo - 1, 0);
    if (w_end < w_start) w_end = w_start;

    // per lane: its row, query character, column-0 boundary (left and
    // diagonal of j == 1), and the wavefronts [v_lo, v_hi] that hold its
    // valid cells (j >= 1, j <= r_len, in band)
    const int i_glob = c * N_PE + lane + 1;
    const Ch qc = sq[c * N_PE + lane];
    S col_b[L], col_d[L], prev[L], dg[L];
#pragma unroll
    for (int l = 0, u = 0; l < L; ++l) {
      col_b[l] = icol[i_glob * L + l];
      prev[l] = SENT;
      dg[l] = SENT;
      col_d[l] = SENT;
      if ((DG >> l) & 1u)  // cell (0, 0) is the init row's
        col_d[l] = (c == 0 && lane == 0) ? irow[u] : icol[(i_glob - 1) * L + l];
      if ((SH >> l) & 1u) ++u;
    }
    int v_lo = lane, v_hi = lane + r_len - 1;
    if (BANDED) {
      v_lo = max(v_lo, c * N_PE + 2 * lane - a.band);
      v_hi = min(v_hi, c * N_PE + 2 * lane + a.band);
    }
    if (i_glob > q_len) v_hi = -1;
    const bool last_row = i_glob == q_len;
    const int w_last_col = lane + r_len - 1;  // the wavefront of j == r_len
    S best = SENT;
    int bestj = 0;

    // handoff bookkeeping, identical in every lane
    int k_done = 0;   // chunks of the input ring released
    int k_held = -1;  // the chunk of the input ring held (== k_done)
    int k_sig = 0;    // chunks of the output ring signalled full
    // lane 0 reads column x of the row above for x in [x_lo, x_hi] (SENT
    // elsewhere): from the init row for strip 0, from the held chunk's slot
    // else, where the strip above holds only the columns inside its last
    // row's band
    int x_lo = 0, x_hi = consume ? rl : R;
    if (BANDED && consume) {
      x_lo = c * N_PE - a.band;
      x_hi = min(x_hi, c * N_PE + a.band);
    }
    auto acquire = [&](int k) {  // release every chunk below k, hold k
      for (; k_done < min(k, NK); ++k_done) {
        if (k_held != k_done) mbar_wait(in_r.full(k_done), in_r.phase(k_done));
        if (lane == 0) mbar_arrive(in_r.empty(k_done));
        k_held = -1;
      }
      if (k < NK && k_held != k) {
        mbar_wait(in_r.full(k), in_r.phase(k));
        k_held = k;
      }
    };
    auto enter = [&](int k) {  // signal skipped chunks, then wait to write k
      for (; k_sig <= k; ++k_sig) {
        if (out_r.seq + k_sig >= NCH)  // the slot held chunk k_sig - NCH
          mbar_wait(out_r.empty(k_sig), out_r.phase(k_sig) - 1);
        if (k_sig == k) break;
        if (lane == N_PE - 1) mbar_arrive(out_r.full(k_sig));
      }
    };

    const int t_first = (w_start + 1) >> 5;
    const int t_last = w_end > w_start ? w_end >> 5 : t_first - 1;
    if (a.with_tb)
      for (int T = 0; T < t_first && T < NT; ++T)
        flush_tile(a.pack, tbs, tile, T, WT, 0, 0, lane);

    if (w_end > w_start) {
      // lane 0's row-above values for the first wavefront (column
      // w_start + 1)
      S pre[NU];
      {
        const int x = w_start + 1;
        const S* src;
        if (consume) {
          acquire(w_start / CH);
          src = in_r.data + in_r.slot(w_start / CH) * CH * NU;
        } else {
          src = irow + ((w_start / CH) * CH + 1) * NU;
        }
        const bool in = x >= x_lo && x <= x_hi;
#pragma unroll
        for (int u = 0; u < NU; ++u)
          pre[u] = in ? src[((x - 1) & (CH - 1)) * NU + u] : SENT;
      }
      // blocks of CH wavefronts: block m = [CH m - 1, CH m + CH - 1) reads
      // (one wavefront ahead) columns CH m + 1 ... CH m + CH, chunk m of the
      // ring above, and writes columns CH (m - 2) + 1 ..., chunk m - 2 below
      for (int m = (w_start + 1) / CH; m <= w_end / CH; ++m) {
        const int lo = max(w_start, CH * m - 1);
        const int hi = min(w_end, CH * m + CH - 1);
        if (lo >= hi) continue;
        const S* src;
        if (consume) {
          acquire(m);
          src = in_r.data + in_r.slot(m) * CH * NU;
        } else {
          src = irow + (m * CH + 1) * NU;
        }
        const int pk = m - N_PE / CH;
        const bool wr = produce && pk >= 0 && pk < NK;
        S* dst = out_r.data + out_r.slot(pk < 0 ? 0 : pk) * CH * NU;
        if (wr) enter(pk);
        for (int w = lo; w < hi; ++w) {
          const int o = (w + 1) & (CH - 1);
          S up[L];
#pragma unroll
          for (int l = 0, u = 0; l < L; ++l) {
            up[l] = SENT;
            if ((SH >> l) & 1u) {
              const S v = __shfl_up_sync(FULL, prev[l], 1);
              up[l] = lane == 0 ? pre[u] : v;
              ++u;
            }
          }
          {  // prefetch column w + 2 for the next wavefront (one broadcast)
            const int x = w + 2;
            const bool in = x >= x_lo && x <= x_hi;
#pragma unroll
            for (int u = 0; u < NU; ++u)
              pre[u] = in ? src[o * NU + u] : SENT;
          }
          // the diagonal is the row above of one wavefront ago
          S diag[L];
#pragma unroll
          for (int l = 0; l < L; ++l) {
            diag[l] = SENT;
            if ((DG >> l) & 1u) {
              diag[l] = dg[l];
              dg[l] = up[l];
            }
          }
          S left[L];
#pragma unroll
          for (int l = 0; l < L; ++l) left[l] = prev[l];
          if (w == lane) {  // j == 1: left and diagonal are column 0
#pragma unroll
            for (int l = 0; l < L; ++l) {
              left[l] = col_b[l];
              if ((DG >> l) & 1u) diag[l] = col_d[l];
            }
          }
          S cur[L];
          int ptr = CellCall<PE>::run(a, tab, qc, sr[w - lane], diag, up,
                                      left, cur, i_glob, w - lane + 1);
          const bool valid = w >= v_lo && w <= v_hi;
          if (!valid) {
#pragma unroll
            for (int l = 0; l < L; ++l) cur[l] = SENT;
            ptr = 0;
          }
          if (a.with_tb) tile[((w + 1) & 31) * TILE_STRIDE + lane] = (uint8_t)ptr;
          if (wr && lane == N_PE - 1) {  // column w - 30 of the bottom row
#pragma unroll
            for (int l = 0, u = 0; l < L; ++l)
              if ((SH >> l) & 1u) dst[o * NU + u++] = cur[l];
          }
          // per-lane fold over the objective region
          bool sel = true;
          if (REGION == 0) sel = last_row && w == w_last_col;
          if (REGION == 2) sel = last_row;
          if (REGION == 3) sel = last_row || w == w_last_col;
          if (valid && sel) fold<PE>(cur[P], w - lane + 1, best, bestj);
#pragma unroll
          for (int l = 0; l < L; ++l) prev[l] = cur[l];
        }
        // chunk pk is complete once the block ran to its last wavefront,
        // CH (pk + 1) + STRIP_LAG - 2
        if (wr && hi - 1 == CH * (pk + 1) + STRIP_LAG - 2) {
          if (lane == N_PE - 1) mbar_arrive(out_r.full(pk));
          k_sig = pk + 1;
        }
        if (consume && k_held == m) {  // block m read its last from chunk m
          if (lane == 0) mbar_arrive(in_r.empty(m));
          k_done = m + 1;
          k_held = -1;
        }
        if (a.with_tb && ((m & 1) || hi == w_end)) {
          __syncwarp();
          flush_tile(a.pack, tbs, tile, m >> 1, WT, w_start, w_end, lane);
          __syncwarp();
        }
      }
    }
    // release what this strip did not read, signal what it did not write
    if (consume) acquire(NK);
    if (produce && k_sig < NK) {
      enter(NK - 1);
      if (lane == N_PE - 1) mbar_arrive(out_r.full(NK - 1));
    }
    if (a.with_tb) {
      for (int T = max(t_last + 1, t_first); T < NT; ++T)
        flush_tile(a.pack, tbs, tile, T, WT, 0, 0, lane);
      __syncwarp();
    }
    bo[lane] = best;
    bjo[lane] = bestj;
  }
}

template <class PE, int REGION, bool BANDED>
int launch(const KArgs& a, cudaStream_t stream) {
  auto kern = wavefront_kernel<PE, REGION, BANDED>;
  const int sub_words = !PE::kTable ? 0
                        : HasSlots<PE>::value ? a.g.n_words
                                              : a.p.n_sub * a.p.n_sub;
  const size_t smem =
      layout(sub_words, a.G, 1 << a.nch_log2, popc(PE::UP | PE::DIAG), a.Q,
             a.R, a.with_tb, (int)sizeof(typename PE::Char))
          .total;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<a.B, a.G * N_PE, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The launch geometry both entry points check: strip_lag and ring_chunk
// must equal STRIP_LAG and CH, warps in [1, min(8, Q / 32)].
inline bool bad_geometry(int Q, int warps, int ring_log2, int strip_lag,
                         int ring_chunk) {
  return strip_lag != STRIP_LAG || ring_chunk != CH || warps < 1 ||
         warps > MAX_WARPS || warps > Q / N_PE || ring_log2 < 0 ||
         ring_log2 > 8;
}

inline KArgs make_args(const void* query, const void* ref,
                       const void* init_row, const void* init_col,
                       const void* lens, const void* sub, const Params& p,
                       int band, void* tb, void* best, void* best_j, int B,
                       int Q, int R, int pack, int with_tb, int warps,
                       int ring_log2) {
  KArgs a;
  a.query = query;
  a.ref = ref;
  a.init_row = init_row;
  a.init_col = init_col;
  a.lens = static_cast<const int*>(lens);
  a.sub = sub;
  a.p = p;
  a.band = band;
  a.tb = static_cast<uint8_t*>(tb);
  a.best = best;
  a.best_j = static_cast<int*>(best_j);
  a.B = B;
  a.Q = Q;
  a.R = R;
  a.pack = pack;
  a.with_tb = with_tb;
  a.G = warps;
  a.nch_log2 = ring_log2;
  a.g = Slots{};
  return a;
}

}  // namespace

extern "C" {

// Largest dynamic shared memory one block may opt into on `device`.
int wavefront_max_smem(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

}  // extern "C"
