// The dropout op's forward in one pass for Hopper (sm_90a): Out and Mask
// of operators/dropout_op.cc from X and a seed in device memory.
//
// Replaces no Pallas kernel.  The JAX package's dropout op draws its mask
// with jax.random.bernoulli inside the XLA step
// (paddle_tpu/ops/nn_ops.py:464-479), which XLA fuses into the
// surrounding elementwise work.  The port's plain version
// (ops/kernels/dropout.py: dropout_plain over hash_keep) is some 17 int32
// PyTorch passes over the tensor per op; this kernel is that function in
// one pass.
//
// What it computes, bitwise the plain version on the card: element i of
// the flattened X keeps where dropout_op_keep(seed, i, threshold)
// (csrc/dropout_hash.cuh); Mask is 1 or 0 in X's dtype; Out is
//   upscale_in_train:   keep ? X / scale : 0   (an IEEE f32 division;
//                       bf16 X divided in f32 and rounded to bf16 once)
//   downgrade_in_infer: X * Mask               (a multiply: NaN * 0 is NaN)
// The seed is read from a 0-d int64 tensor on the device (its low 32
// bits), so a CUDA-graph replay draws the mask of the step it replays.
//
// Bound on the H100: bytes.  It reads X once and writes Out and Mask:
// 3 x 4 bytes an element in f32, about 0.28 ms for BERT-base's 79M
// elements a training step at 3.35 TB/s.  The hash is ~10 integer
// operations an element, far under the integer pipes' rate.
//
// Design: each thread moves 16 bytes of each stream (4 f32 or 8 bf16
// elements) with one vector load and two vector stores, in a grid-stride
// loop; a tensor whose three pointers are not all 16-byte aligned, and
// the last n % vector elements, go element by element in the same launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as PyTorch's bf16
}

template <typename T>
__device__ __forceinline__ void one(T x, uint32_t seed, uint32_t i,
                                    uint32_t threshold, float scale,
                                    bool upscale, T* out, T* mask) {
  const bool keep = dropout_op_keep(seed, i, threshold);
  const float m = keep ? 1.0f : 0.0f;
  const float xf = to_f(x);
  float o;
  if (upscale) {
    o = keep ? __fdiv_rn(xf, scale) : 0.0f;
  } else {
    o = __fmul_rn(xf, m);
  }
  *out = from_f<T>(o);
  *mask = from_f<T>(m);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dropout_fwd(const T* __restrict__ x, T* __restrict__ out,
            T* __restrict__ mask, long long n, long long nvec,
            const long long* __restrict__ seed_ptr, uint32_t threshold,
            float scale, int upscale) {
  constexpr int kVec = 16 / sizeof(T);
  const uint32_t seed = (uint32_t)(unsigned long long)(*seed_ptr);
  const bool up = upscale != 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long v = tid; v < nvec; v += stride) {
    const uint4 xin = reinterpret_cast<const uint4*>(x)[v];
    uint4 o, m;
    const T* xe = reinterpret_cast<const T*>(&xin);
    T* oe = reinterpret_cast<T*>(&o);
    T* me = reinterpret_cast<T*>(&m);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      one<T>(xe[j], seed, (uint32_t)(v * kVec + j), threshold, scale, up,
             oe + j, me + j);
    }
    reinterpret_cast<uint4*>(out)[v] = o;
    reinterpret_cast<uint4*>(mask)[v] = m;
  }
  for (long long i = nvec * kVec + tid; i < n; i += stride) {
    one<T>(x[i], seed, (uint32_t)i, threshold, scale, up, out + i, mask + i);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, void* mask, long long n,
                   const void* seed, uint32_t threshold, float scale,
                   int upscale, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const uintptr_t align = (uintptr_t)x | (uintptr_t)out | (uintptr_t)mask;
  const long long nvec = align % 16 == 0 ? n / kVec : 0;
  const long long work = nvec + (n - nvec * kVec);
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  dropout_fwd<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const T*)x, (T*)out, (T*)mask, n, nvec, (const long long*)seed,
      threshold, scale, upscale);
  return cudaGetLastError();
}

}  // namespace

// x, out, mask: [n] contiguous, f32 (dtype 0) or bf16 (dtype 1); seed: a
// 0-d int64 on the device; threshold: the 24-bit keep threshold
// round((1 - p) * 2**24); scale: max(1 - p, 1e-8) as f32; upscale: 1 for
// upscale_in_train, 0 for downgrade_in_infer.  n < 2**31.  Returns the
// CUDA error of the launch (0 on success).
extern "C" int dropout_mask(const void* x, void* out, void* mask, long long n,
                            int dtype, const void* seed, unsigned threshold,
                            float scale, int upscale, void* stream) {
  if (n <= 0) return 0;
  if (n >= (1LL << 31) || threshold > (1u << 24))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float>(x, out, mask, n, seed, threshold, scale,
                              upscale, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, out, mask, n, seed, threshold,
                                      scale, upscale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
