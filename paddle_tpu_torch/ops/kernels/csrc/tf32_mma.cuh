// Tile and tensor-core helpers shared by the flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu): f32 / bf16 element
// loads and pair stores, [B, T, H, D] row addressing, 16- and 4-byte
// cp.async copies into padded shared-memory tiles (rows past T
// zero-filled), f32-accurate products on the TF32 tensor cores
// (mma.sync m16n8k8 with the 3xTF32 split) with the fragment reads of a
// tile as A, as B transposed, as B with the permutation an accumulator
// fed back as an A operand needs, and the host-side shared-memory
// opt-in and alignment check.  A kernel of `Threads` threads copies a
// tile with all of them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

struct Strides {
  long long b, t, h;  // element strides over b, t, h (d is 1)
};

__device__ __forceinline__ long long row_off(const Strides& s, int b,
                                             int t, int h) {
  return (long long)b * s.b + (long long)t * s.t + (long long)h * s.h;
}

// ------------------------------------------------------ async copies

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename Elt, int D>
struct TileShape {
  static constexpr int kLd = D + 16 / (int)sizeof(Elt);  // padded row
  static constexpr int kPerRow = D * (int)sizeof(Elt) / 16;  // copies
};

// rows r0 .. r0 + R - 1 of a [B, T, H, D] tensor at (b, h) into a
// [R][kLd] tile; rows past T are zero-filled
template <typename Elt, int D, int R, int Threads>
__device__ __forceinline__ void copy_rows(Elt* dst, const void* base,
                                          const Strides& s, int b, int h,
                                          int r0, int t_len, int tid) {
  using Sh = TileShape<Elt, D>;
  const Elt* src = (const Elt*)base;
  constexpr int kEl = 16 / (int)sizeof(Elt);
#pragma unroll
  for (int i = tid; i < R * Sh::kPerRow; i += Threads) {
    const int r = i / Sh::kPerRow, c = i - r * Sh::kPerRow;
    const int row = r0 + r;
    const bool ok = row < t_len;
    cp_async16(dst + r * Sh::kLd + c * kEl,
               ok ? src + row_off(s, b, row, h) + c * kEl : src, ok);
  }
}

// x[r0 .. r0 + R - 1] of one [T] row into dst; past T zero-filled
template <int R, int Threads>
__device__ __forceinline__ void copy_vec(float* dst, const float* x, int r0,
                                         int t_len, int tid) {
  for (int i = tid; i < R; i += Threads) {
    const bool ok = r0 + i < t_len;
    cp_async4(dst + i, ok ? x + r0 + i : x, ok);
  }
}

// ------------------------------------------------- 3xTF32 mma.sync

// x = big + small: big is x with its 13 low bits cleared (TF32, rounded
// toward zero) and small = x - big, exact in f32, which the tensor core
// reads truncated to TF32 in turn.  Two operations an operand; the
// products' error stays near 2^-20 of their size, f32-grade.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

struct FragA {  // 16 x 8, split
  uint32_t big[4], small[4];
};
struct FragB {  // 8 x 8, split
  uint32_t big[2], small[2];
};

__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2,
                                        float a3) {
  FragA f;
  split_tf32(a0, f.big[0], f.small[0]);
  split_tf32(a1, f.big[1], f.small[1]);
  split_tf32(a2, f.big[2], f.small[2]);
  split_tf32(a3, f.big[3], f.small[3]);
  return f;
}
__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split_tf32(b0, f.big[0], f.small[0]);
  split_tf32(b1, f.big[1], f.small[1]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in f32 accuracy: the two small cross terms first
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.small, b.big);
  mma_tf32(d, a.big, b.small);
  mma_tf32(d, a.big, b.big);
}

// A fragment of rows r .. r + 15, columns c .. c + 7 of a [.][ld] tile
template <typename Elt>
__device__ __forceinline__ FragA tile_a(const Elt* t, int ld, int r, int c,
                                        int g, int t4) {
  const Elt* p = t + (r + g) * ld + c + t4;
  return frag_a(load_f(p), load_f(p + 8 * ld), load_f(p + 4),
                load_f(p + 8 * ld + 4));
}
// B fragment (k = column, n = row) of rows n .. n + 7, columns k .. k + 7
// of a [.][ld] tile: the transposed rows, for products with a tile^T
template <typename Elt>
__device__ __forceinline__ FragB tile_bt(const Elt* t, int ld, int n, int k,
                                         int g, int t4) {
  const Elt* p = t + (n + g) * ld + k + t4;
  return frag_b(load_f(p), load_f(p + 4));
}
// B fragment (k = row, n = column) of rows k .. k + 7, columns n .. n + 7,
// the k index t read from row 2t and t + 4 from row 2t + 1 (the order an
// accumulator turned into an A fragment has)
template <typename Elt>
__device__ __forceinline__ FragB tile_b_perm(const Elt* t, int ld, int k,
                                             int n, int g, int t4) {
  const Elt* p = t + (k + 2 * t4) * ld + n + g;
  return frag_b(load_f(p), load_f(p + ld));
}
// an accumulator (16 x 8: columns 2t, 2t + 1) as an A fragment
__device__ __forceinline__ FragA acc_a(const float (&c)[4]) {
  return frag_a(c[0], c[2], c[1], c[3]);
}

// ------------------------------------------------------------- host

// opt in to more than 48 KB of shared memory once per device and kernel
// (not on every launch, so a launch can be captured in a CUDA graph)
template <typename Kernel>
cudaError_t configure(Kernel kernel, size_t smem, bool* configured) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    configured[dev] = true;
  }
  return cudaSuccess;
}

Strides strides_at(const long long* s, int i) {
  Strides r;
  r.b = s[3 * i];
  r.t = s[3 * i + 1];
  r.h = s[3 * i + 2];
  return r;
}

// every row the kernels copy with 16-byte cp.async starts on 16 bytes
bool copy_aligned(const void* x, const Strides& s, int elt_bytes) {
  const long long step = 16 / elt_bytes;
  return ((uintptr_t)x % 16) == 0 && s.b % step == 0 && s.t % step == 0 &&
         s.h % step == 0;
}

}  // namespace
