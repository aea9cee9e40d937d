// Device helpers shared by the embedding scatter-add
// (embedding_scatter.cu) and the sparse Adagrad row update
// (embedding_update.cu, radix_sort.cuh): an id read as int64 or int32
// and clipped into [0, nrows), the ballot ranking of a radix digit
// within a warp, 16- and 4-byte cp.async copies into shared memory, and
// the f32 / float4 add.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ unsigned clipped_id(const void* ids, int id_bytes,
                                               long long i, int nrows) {
  long long id = id_bytes == 8 ? ((const long long*)ids)[i]
                               : (long long)((const int*)ids)[i];
  id = id < 0 ? 0 : (id >= nrows ? nrows - 1 : id);
  return (unsigned)id;
}

// The lanes among `peers` whose digit equals this lane's in its low
// `bits` bits (bits <= MaxBits, the same in every lane of the warp,
// all of which call it).
template <int MaxBits>
__device__ __forceinline__ unsigned digit_peers(unsigned digit, int bits,
                                                unsigned peers) {
#pragma unroll
  for (int b = 0; b < MaxBits; ++b) {
    if (b >= bits) break;
    const unsigned set = __ballot_sync(0xffffffffu, (digit >> b) & 1u);
    peers &= ((digit >> b) & 1u) ? set : ~set;
  }
  return peers;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// A 16-byte (.cg, around L1) or 4-byte (.ca) copy of src into shared
// dst; the bytes past src_bytes (0 or `bytes`) are zero-filled.
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int bytes, int src_bytes) {
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void vadd(float& a, float b) { a += b; }
__device__ __forceinline__ void vadd(float4& a, const float4& b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}

}  // namespace
