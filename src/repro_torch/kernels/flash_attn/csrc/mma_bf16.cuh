// K3's tensor-core building blocks, shared by the forward (flash_attn.cu)
// and the backward (flash_attn_bwd.cu): cp.async of 64-row bf16 tiles into
// shared memory, ldmatrix fragment loads, the m16n8k16 bf16 mma.sync with
// f32 accumulators, and the packing of f32 fragments into bf16 A operands.
//
// Tiles sit in shared memory as bf16 rows of HD + SPAD elements: the
// 16-byte pad puts the 8 row addresses of an ldmatrix in distinct bank
// groups.  Fragment layouts (lane = 4 g + tig):
//   A (16 x 16, row):  a[0] (row g, cols 2 tig, 2 tig + 1), a[1] row g + 8,
//                      a[2] row g, cols + 8, a[3] row g + 8, cols + 8;
//   B (16 x 8, col):   b0 (k 2 tig, 2 tig + 1; col g), b1 k + 8;
//   C (16 x 8):        c[0], c[1] (row g, cols 2 tig, 2 tig + 1),
//                      c[2], c[3] row g + 8.
// So the accumulators of two adjacent n8 octets of a product are, packed
// to bf16, the A fragment of a k16 step of the next product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int TILE_ROWS = 64;            // rows of a tile load_tile moves
constexpr int SPAD = 8;                  // row padding (bf16): 16 bytes

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16 pair, lo in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two floats x0, x1 as two bf16 pairs: hi = bf16(x) and lo = bf16(x - hi),
// so hi + lo carries about 16 bits of x's mantissa, and a product taken as
// hi b + lo b is within about 2^-17 |x b| of x b.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// A 64-row tile of one head, rows row0 .. row0 + 63 of a (S, heads, HD)
// slab with row_stride elements between rows, into shared memory
// [64][HD + SPAD] by cp.async from THREADS threads; rows past S are
// zero-filled.
template <int HD, int THREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          size_t row_stride, int row0,
                                          int S) {
  constexpr int CPR = HD / 8;            // 16-byte chunks per row
  constexpr int RS = HD + SPAD;
  for (int e = threadIdx.x; e < TILE_ROWS * CPR; e += THREADS) {
    const int row = e / CPR, ch = e % CPR;
    const int pos = row0 + row;
    const bool in = pos < S;
    cp_async16(smem_addr(dst + row * RS + ch * 8),
               src + (size_t)(in ? pos : 0) * row_stride + ch * 8,
               in ? 16 : 0);
  }
}

}  // namespace
