// bf16 tensor-core helpers shared by the bf16 routes of the
// flash-attention kernels (flash_attention_fwd.cu, flash_attention_bwd.cu):
// mma.sync m16n8k16 with bf16 operands and f32 accumulators, and the
// fragment reads of a bf16 [.][ld] shared-memory tile as A, as B
// transposed (a product with tile^T) and as B (a product with the tile),
// and two adjacent accumulators turned into one A fragment.  The tiles,
// copies and host helpers are tf32_mma.cuh's.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16), lane = 4 g + t:
//   A (16 x 16): a0 = (g, 2t..2t+1), a1 = (g + 8, 2t..2t+1),
//                a2 = (g, 2t+8..2t+9), a3 = (g + 8, 2t+8..2t+9);
//   B (16 x 8):  b0 = (k 2t..2t+1, n g), b1 = (k 2t+8..2t+9, n g);
//   C (16 x 8):  c0, c1 = (g, 2t..2t+1), c2, c3 = (g + 8, 2t..2t+1);
// each .b32 register holds two bf16 values, the lower index in the low
// half.  So the C fragments of two adjacent n8 tiles are, rounded to
// bf16, the A fragment of their 16 columns: P and dS never leave the
// registers.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

struct FragA16 {  // 16 x 16 bf16
  uint32_t x[4];
};
struct FragB16 {  // 16 x 8 bf16
  uint32_t x[2];
};

// two f32 values rounded to nearest even bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a b, bf16 operands, f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const FragA16& a,
                                         const FragB16& b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x[0]), "r"(a.x[1]), "r"(a.x[2]), "r"(a.x[3]), "r"(b.x[0]),
        "r"(b.x[1]));
}

// A fragment of rows r .. r + 15, columns c .. c + 15 of a [.][ld] tile
__device__ __forceinline__ FragA16 tile_a16(const __nv_bfloat16* t, int ld,
                                            int r, int c, int g, int t4) {
  const __nv_bfloat16* p = t + (r + g) * ld + c + 2 * t4;
  FragA16 f;
  f.x[0] = ld_pair(p);
  f.x[1] = ld_pair(p + 8 * ld);
  f.x[2] = ld_pair(p + 8);
  f.x[3] = ld_pair(p + 8 * ld + 8);
  return f;
}
// B fragment (k = column, n = row) of rows n .. n + 7, columns
// k .. k + 15: the transposed rows, for products with a tile^T
__device__ __forceinline__ FragB16 tile_bt16(const __nv_bfloat16* t, int ld,
                                             int n, int k, int g, int t4) {
  const __nv_bfloat16* p = t + (n + g) * ld + k + 2 * t4;
  FragB16 f;
  f.x[0] = ld_pair(p);
  f.x[1] = ld_pair(p + 8);
  return f;
}
// B fragment (k = row, n = column) of rows k .. k + 15, columns
// n .. n + 7: two rows' values packed a register
__device__ __forceinline__ FragB16 tile_b16(const __nv_bfloat16* t, int ld,
                                            int k, int n, int g, int t4) {
  const __nv_bfloat16* p = t + (k + 2 * t4) * ld + n + g;
  FragB16 f;
  f.x[0] = pack_raw(p[0], p[ld]);
  f.x[1] = pack_raw(p[8 * ld], p[9 * ld]);
  return f;
}
// the accumulators of columns 0..7 (lo) and 8..15 (hi) of 16 rows,
// rounded to bf16, as the A fragment of those 16 columns
__device__ __forceinline__ FragA16 acc_a16(const float (&lo)[4],
                                           const float (&hi)[4]) {
  FragA16 f;
  f.x[0] = pack_bf16(lo[0], lo[1]);
  f.x[1] = pack_bf16(lo[2], lo[3]);
  f.x[2] = pack_bf16(hi[0], hi[1]);
  f.x[3] = pack_bf16(hi[2], hi[3]);
  return f;
}

}  // namespace
