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
// the cell above (PE::UP: H for linear, H and D for affine, H, D1 and D2 for
// two-piece); the diagonal neighbour is the H it received one wavefront
// earlier, and column 0 comes from the init column.  The pair's reference
// and query codes and the init row's UP layers are staged in shared memory
// once (cp.async), so the wavefront loop reads nothing from device memory:
// each lane reads its own reference code ref[w - l].  Each lane's valid
// wavefronts (j in [1, r_len], inside the band, its row live) are one
// interval computed before the loop.  Pointers go to a 32-wavefront tile
// per warp in shared memory, one byte per lane; every 32 wavefronts each
// lane packs one wavefront's bytes from 8 words and the warp writes each
// lane-byte row of the strip as 32 contiguous bytes.  The kernel writes every byte of the store, zeros for
// skipped wavefronts, dead strips and out-of-band cells, so the wrapper
// allocates it uninitialised.  A banded strip visits only the wavefronts
// that hold a cell with |i - j| <= band in one of its rows.
//
// What bounds it.  Each cell costs a handful of int32 ALU operations per
// score layer (adds, maxes, compares, selects) plus the shuffles, the tile
// byte and the best update, so the int32 issue rate binds before memory
// bandwidth at every bucket size.  A warp alone issues a wavefront's few
// dozen dependent instructions at a handful of cycles each, so the card
// needs many warps resident to reach that rate.  What it does not do yet:
// the rows of the store are 32 + R - 1 bytes long, odd for even R, so a
// lane-byte row is not 16-byte aligned and the tile goes out as byte stores
// that the warp coalesces 32 at a time; the pipeline's fill and drain leave
// each warp idle for about (G - 1) x 47 of a pair's wavefronts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N_PE = 32;
constexpr int STRIP_LAG = 32;   // mirrors kernel.py STRIP_LAG
constexpr int CH = 16;          // columns per handoff chunk
constexpr int MAX_WARPS = 8;    // warps per pair (block)
constexpr int TILE_STRIDE = 36; // bytes per wavefront in the pointer tile
constexpr int REF_PAD = 32;     // slack bytes on each side of the codes
// A block of CH wavefronts ends exactly where the chunk it writes is
// complete, CH (k + 1) + STRIP_LAG - 2, when the lag is two chunks.
static_assert(STRIP_LAG == 2 * CH, "the block grid assumes STRIP_LAG == 2 CH");
static_assert(N_PE % CH == 0 && (CH & (CH - 1)) == 0, "CH: a power of 2");
constexpr int SENT = -(1 << 30);
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int popc(unsigned v) {
  return v ? (int)(v & 1u) + popc(v >> 1) : 0;
}

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
// greater, which decides the stored pointer under ties.  UP is the mask of
// the layers the PE reads from the cell above; every PE reads only layer 0
// (H) of the diagonal neighbour.
template <class SubT, bool LOCAL>
struct LinearPE {
  using Sub = SubT;
  static constexpr int L = 1;
  static constexpr unsigned UP = 0x1;
  __device__ __forceinline__ static int cell(const Params& p, const int* sub, int q, int r,
                             int diag, const int* up, const int* left,
                             int* out) {
    const int m = diag + Sub::score(p, sub, q, r);
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
  static constexpr unsigned UP = 0x5;
  __device__ __forceinline__ static int cell(const Params& p, const int* sub, int q, int r,
                             int diag, const int* up, const int* left,
                             int* out) {
    const int ins_open = left[0] + p.gap_open;
    const int ins_ext = left[1] + p.gap_extend;
    const int ins = max(ins_open, ins_ext);
    const int i_ext = ins_ext > ins_open;
    const int del_open = up[0] + p.gap_open;
    const int del_ext = up[2] + p.gap_extend;
    const int dele = max(del_open, del_ext);
    const int d_ext = del_ext > del_open;
    int h = diag + Sub::score(p, sub, q, r);
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
  static constexpr unsigned UP = 0x15;
  __device__ __forceinline__ static int cell(const Params& p, const int* sub, int q, int r,
                             int diag, const int* up, const int* left,
                             int* out) {
    const int i1o = left[0] + p.gap_open, i1x = left[1] + p.gap_extend;
    const int d1o = up[0] + p.gap_open, d1x = up[2] + p.gap_extend;
    const int i2o = left[0] + p.gap_open2, i2x = left[3] + p.gap_extend2;
    const int d2o = up[0] + p.gap_open2, d2x = up[4] + p.gap_extend2;
    const int i1 = max(i1o, i1x), d1 = max(d1o, d1x);
    const int i2 = max(i2o, i2x), d2 = max(d2o, d2x);
    int h = diag + Sub::score(p, sub, q, r);
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

// ---- shared-memory layout of one block (kernel.py smem_bytes mirrors it)
__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

struct Layout {
  size_t bar, sub, ring, irow, tile, qry, ref, total;
};

__host__ __device__ inline Layout layout(int sub_ints, int G, int nch,
                                         int nu, int Q, int R, int with_tb) {
  Layout s;
  size_t o = 0;
  s.bar = o;
  o += align16((size_t)G * nch * 2 * sizeof(uint64_t));
  s.sub = o;
  o += align16((size_t)sub_ints * 4);
  s.ring = o;
  o += align16((size_t)G * nch * CH * nu * 4);
  s.irow = o;
  o += align16((size_t)(R + 1) * nu * 4);
  s.tile = o;
  o += with_tb ? (size_t)G * N_PE * TILE_STRIDE : 0;
  s.qry = o;
  o += align16(Q);
  s.ref = o;
  o += align16(R + 2 * REF_PAD);
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

struct KArgs {
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
  int B, Q, R, pack, with_tb, G, nch_log2;
};

// The handoff ring one strip boundary carries: NK chunks of CH columns
// through 1 << nch_log2 slots, chunk n (counted over the pairs' strips that
// use this boundary) in slot n % NCH, phase n / NCH of its barriers.
struct Ring {
  int* data;       // NCH x CH x NU ints
  uint64_t* bars;  // per slot: full, empty
  int seq;         // chunk count before this strip's first chunk
  int log2;
  __device__ int slot(int k) const { return (seq + k) & ((1 << log2) - 1); }
  __device__ int phase(int k) const { return (seq + k) >> log2; }
  __device__ uint64_t* full(int k) const { return bars + 2 * slot(k); }
  __device__ uint64_t* empty(int k) const { return bars + 2 * slot(k) + 1; }
};

template <class PE, int REGION, bool BANDED>
__global__ void __launch_bounds__(MAX_WARPS * N_PE)
    wavefront_kernel(const KArgs a) {
  constexpr int L = PE::L;
  constexpr unsigned UP = PE::UP;
  constexpr int NU = popc(UP);
  extern __shared__ __align__(16) unsigned char smem[];
  const int Q = a.Q, R = a.R, G = a.G, NCH = 1 << a.nch_log2;
  const int sub_ints = PE::Sub::kMatrix ? a.p.n_sub * a.p.n_sub : 0;
  const Layout lay = layout(sub_ints, G, NCH, NU, Q, R, a.with_tb);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bar);
  int* sub = reinterpret_cast<int*>(smem + lay.sub);
  int* rings = reinterpret_cast<int*>(smem + lay.ring);
  int* irow = reinterpret_cast<int*>(smem + lay.irow);
  uint8_t* tiles = smem + lay.tile;
  uint8_t* sq = smem + lay.qry;
  uint8_t* sr = smem + lay.ref + REF_PAD;  // sr[-REF_PAD .. R + REF_PAD)

  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int C = Q / N_PE;
  const int WT = N_PE + R - 1;
  const int LB = N_PE / a.pack;
  const int q_len = a.lens[2 * b];
  const int r_len = a.lens[2 * b + 1];

  // ---- stage the pair's codes, the init row's UP layers and the matrix
  const uint8_t* qb = a.query + (size_t)b * Q;
  const uint8_t* rb = a.ref + (size_t)b * R;
  const int* irow_g = a.init_row + (size_t)b * (R + 1) * L;
  const int* icol = a.init_col + (size_t)b * (Q + 1) * L;
  if (((uintptr_t)qb & 15) == 0) {
    for (int t = threadIdx.x; t < Q / 16; t += blockDim.x)
      cp_async16(sq + 16 * t, qb + 16 * t);
  } else {
    for (int t = threadIdx.x; t < Q; t += blockDim.x) sq[t] = qb[t];
  }
  for (int t = threadIdx.x; t < (R + 1) * NU; t += blockDim.x) {
    const int x = t / NU, u = t % NU;
    int l = 0;  // the u-th set bit of UP
    for (int k = 0, seen = 0; k < L; ++k)
      if ((UP >> k) & 1u) {
        if (seen == u) l = k;
        ++seen;
      }
    cp_async4(irow + t, irow_g + x * L + l);
  }
  // reference codes with REF_PAD bytes of slack on each side, so that lane
  // l reads ref[w - l] unclamped (the cells past either end are invalid)
  for (int t = threadIdx.x - REF_PAD; t < R + REF_PAD; t += blockDim.x)
    sr[t] = (t >= 0 && t < R) ? rb[t] : 0;
  for (int t = threadIdx.x; t < sub_ints; t += blockDim.x) sub[t] = a.sub[t];
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
    int* bo = a.best + ((size_t)b * C + c) * N_PE;
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
    const int ring_ints = CH * NU << a.nch_log2;
    const Ring in_r{rings + gin * ring_ints, bars + gin * NCH * 2,
                    consume ? ((c - 1) / G) * NK : 0, a.nch_log2};
    const Ring out_r{rings + gout * ring_ints, bars + gout * NCH * 2,
                     (c / G) * NK, a.nch_log2};

    // the wavefronts this strip visits; one before the first live one, so
    // that lane 0 carries that column's H as the diagonal of the next
    int w_lo = 0, w_end = n_w;
    if (BANDED) {
      const int l_max = min(N_PE - 1, q_len - c * N_PE - 1);
      w_lo = max(0, c * N_PE - a.band);
      w_end = min(n_w, c * N_PE + 2 * l_max + a.band + 1);
    }
    const int w_start = max(w_lo - 1, 0);
    if (w_end < w_start) w_end = w_start;

    // per lane: its row, query code, column-0 boundary, and the wavefronts
    // [v_lo, v_hi] that hold its valid cells (j >= 1, j <= r_len, in band)
    const int i_glob = c * N_PE + lane + 1;
    const int qc = sq[c * N_PE + lane];
    int col_b[L], prev[L];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      col_b[l] = icol[i_glob * L + l];
      prev[l] = SENT;
    }
    const int col_d = (c == 0 && lane == 0) ? irow[0] : icol[(i_glob - 1) * L];
    int v_lo = lane, v_hi = lane + r_len - 1;
    if (BANDED) {
      v_lo = max(v_lo, c * N_PE + 2 * lane - a.band);
      v_hi = min(v_hi, c * N_PE + 2 * lane + a.band);
    }
    if (i_glob > q_len) v_hi = -1;
    const bool last_row = i_glob == q_len;
    const int w_last_col = lane + r_len - 1;  // the wavefront of j == r_len
    int up_h = SENT;  // H of the cell above, one wavefront ago
    int best = SENT, bestj = 0;

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
      // lane 0's row-above value for the first wavefront (column w_start + 1)
      int pre[NU];
      {
        const int x = w_start + 1;
        const int* src;
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
        const int* src;
        if (consume) {
          acquire(m);
          src = in_r.data + in_r.slot(m) * CH * NU;
        } else {
          src = irow + (m * CH + 1) * NU;
        }
        const int pk = m - N_PE / CH;
        const bool wr = produce && pk >= 0 && pk < NK;
        int* dst = out_r.data + out_r.slot(pk < 0 ? 0 : pk) * CH * NU;
        if (wr) enter(pk);
        for (int w = lo; w < hi; ++w) {
          const int o = (w + 1) & (CH - 1);
          int up[L];
#pragma unroll
          for (int l = 0, u = 0; l < L; ++l) {
            up[l] = SENT;
            if ((UP >> l) & 1u) {
              const int v = __shfl_up_sync(FULL, prev[l], 1);
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
          int diag = up_h;
          up_h = up[0];
          int left[L];
#pragma unroll
          for (int l = 0; l < L; ++l) left[l] = prev[l];
          if (w == lane) {  // j == 1: left and diagonal are column 0
#pragma unroll
            for (int l = 0; l < L; ++l) left[l] = col_b[l];
            diag = col_d;
          }
          int cur[L];
          int ptr = PE::cell(a.p, sub, qc, sr[w - lane], diag, up, left, cur);
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
              if ((UP >> l) & 1u) dst[o * NU + u++] = cur[l];
          }
          // per-lane best over the objective region; strict > keeps the
          // first j
          bool sel = true;
          if (REGION == 0) sel = last_row && w == w_last_col;
          if (REGION == 2) sel = last_row;
          if (REGION == 3) sel = last_row || w == w_last_col;
          if (valid && sel && cur[0] > best) {
            best = cur[0];
            bestj = w - lane + 1;
          }
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
  const int sub_ints = PE::Sub::kMatrix ? a.p.n_sub * a.p.n_sub : 0;
  const size_t smem = layout(sub_ints, a.G, 1 << a.nch_log2, popc(PE::UP),
                             a.Q, a.R, a.with_tb)
                          .total;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<a.B, a.G * N_PE, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

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
  if (strip_lag != STRIP_LAG || ring_chunk != CH || warps < 1 ||
      warps > MAX_WARPS || warps > Q / N_PE || ring_log2 < 0 ||
      ring_log2 > 8)
    return (int)cudaErrorInvalidValue;
  KArgs a;
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
  a.G = warps;
  a.nch_log2 = ring_log2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool banded = band >= 0;
  return matrix ? by_family<MatrixSub>(family, local, region, banded, a, s)
                : by_family<DnaSub>(family, local, region, banded, a, s);
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
