// The dropout op's forward and its gradient for Hopper (sm_90a), each
// one pass: Out (and Mask where something reads it) of
// operators/dropout_op.cc from X and a seed in device memory, and dX
// from dOut and the same seed, the keep bits computed again.
//
// Replaces no Pallas kernel.  The JAX package's dropout op draws its mask
// with jax.random.bernoulli inside the XLA step
// (paddle_tpu/ops/nn_ops.py:464-479), which XLA fuses into the
// surrounding elementwise work and whose unread Mask it never writes.
// The port's plain versions (ops/kernels/dropout.py: dropout_plain and
// dropout_grad_plain over hash_keep) are some 17 int32 PyTorch passes
// over the tensor per call; these kernels are those functions in one
// pass each.
//
// What they compute, bitwise the plain versions on the card: element i
// of the flattened tensor keeps where dropout_op_keep(seed, i,
// threshold) (csrc/dropout_hash.cuh); Mask is 1 or 0 in X's dtype; Out is
//   upscale_in_train:   keep ? X / scale : 0   (an IEEE f32 division;
//                       bf16 X divided in f32 and rounded to bf16 once)
//   downgrade_in_infer: X * Mask               (a multiply: NaN * 0 is NaN)
// and dX the same formula with dOut in place of X.  The seed is read
// from a 0-d int64 tensor on the device (its low 32 bits), so a
// CUDA-graph replay draws the mask of the step it replays.
//
// Bound on the H100: bytes.  The forward reads X once and writes Out,
// and Mask only where it is asked for: 8 bytes an element in f32 (12
// with Mask), 4 in bf16 (6); the gradient reads dOut and writes dX, as
// many bytes as the forward without Mask.  At BERT-base's [8, 512, 768]
// f32 that is 25 MB, 0.0075 ms at 3.35 TB/s.  The work is ~12 integer
// operations of the hash an element and the quotient, which in bf16 sit
// close to the issue rate: there the f32 division's sequence and its
// branch to a slow path cost a sixth of the time (PERF.md), so the
// quotient is an f64 product instead (quotient(), bitwise the division).
//
// Design: one wave of blocks (the SMs times the blocks the occupancy
// calculator lets each hold), each thread walking the tensor in steps
// of the whole grid's threads, one 16-byte vector (4 f32 or 8 bf16
// elements) a step; the seed is read by every thread beside its first
// load.  A tensor whose pointers are not all 16-byte aligned, and the
// last n % vector elements, go element by element in the same launch.
// The f32 division, several vectors in flight a thread, a fixed grid,
// the seed read once a block and evict-first Mask stores were each timed
// beside these choices and none was faster (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

constexpr int kThreads = 256;

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

// v / scale rounded once to f32: the IEEE quotient, from rd, the f64
// reciprocal of scale rounded to nearest.  The f64 product v * rd lies
// within 2^-52 of v / scale (relative), while v / scale, a quotient of two
// 24-bit significands with scale in [1e-8, 1], lies at least ~2^-49 from
// every f32 rounding boundary and never on one; so rounding the product to
// f32 gives the division's result for every number v: zero, subnormal,
// infinite and overflowing quotients included.  A NaN v gives a NaN of
// another payload than the division's: f32 outputs take the division's
// NaN from nan_quotients().  Three conversion and f64 instructions in
// place of the division's sequence and its branch to a slow path.
__device__ __forceinline__ float quotient(float v, double rd) {
  return __double2float_rn(__dmul_rn((double)v, rd));
}

// For f32 elements: where a kept element of xe[0..count) is NaN, the
// division's own NaN in oe (bf16 rounds every NaN to the one bf16 NaN,
// the division's or not).  One branch a vector, taken only where the
// vector holds a NaN.
template <typename T>
__device__ __forceinline__ void nan_quotients(const T* xe, T* oe, int count,
                                              uint32_t seed, uint32_t i0,
                                              uint32_t threshold,
                                              float scale) {
  if (sizeof(T) != 4) return;
  bool nan = false;
#pragma unroll
  for (int j = 0; j < count; ++j) nan |= isnan(to_f(xe[j]));
  if (!nan) return;
  for (int j = 0; j < count; ++j)
    if (isnan(to_f(xe[j])) && dropout_op_keep(seed, i0 + j, threshold))
      oe[j] = from_f<T>(__fdiv_rn(to_f(xe[j]), scale));
}

// The op's formula for one element: keep ? v / scale : 0 (upscale) or
// v * (keep ? 1 : 0).
__device__ __forceinline__ float apply(float v, bool keep, double rd,
                                       bool upscale) {
  if (upscale) return keep ? quotient(v, rd) : 0.0f;
  return __fmul_rn(v, keep ? 1.0f : 0.0f);
}

// y = the formula of src (X or dOut) with the element's keep bit, in
// 16-byte vectors; mask (the forward's, kMask) gets the keep bits.
template <typename T, bool kMask>
__global__ void __launch_bounds__(kThreads)
dropout_pass(const T* __restrict__ src, T* __restrict__ y,
             T* __restrict__ mask, long long n, long long nvec,
             const long long* __restrict__ seed_ptr, uint32_t threshold,
             float scale, int upscale) {
  constexpr int kVec = 16 / sizeof(T);
  const bool up = upscale != 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const uint4* src4 = reinterpret_cast<const uint4*>(src);
  uint4* y4 = reinterpret_cast<uint4*>(y);
  uint4* mask4 = reinterpret_cast<uint4*>(mask);
  // every thread's own load: the warp's lanes share one transaction,
  // and no thread waits on a barrier before its first vector loads
  const uint32_t seed = (uint32_t)(unsigned long long)__ldg(seed_ptr);
  const double rd = 1.0 / (double)scale;
  for (long long v = tid; v < nvec; v += stride) {
    const uint4 in = __ldg(src4 + v);
    uint4 o, m;
    const T* xe = reinterpret_cast<const T*>(&in);
    T* oe = reinterpret_cast<T*>(&o);
    T* me = reinterpret_cast<T*>(&m);
    const uint32_t i0 = (uint32_t)(v * kVec);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const bool keep = dropout_op_keep(seed, i0 + j, threshold);
      oe[j] = from_f<T>(apply(to_f(xe[j]), keep, rd, up));
      if (kMask) me[j] = from_f<T>(keep ? 1.0f : 0.0f);
    }
    if (up) nan_quotients(xe, oe, kVec, seed, i0, threshold, scale);
    y4[v] = o;
    if (kMask) mask4[v] = m;
  }
  for (long long i = nvec * kVec + tid; i < n; i += stride) {
    const bool keep = dropout_op_keep(seed, (uint32_t)i, threshold);
    y[i] = from_f<T>(apply(to_f(src[i]), keep, rd, up));
    if (up) nan_quotients(src + i, y + i, 1, seed, (uint32_t)i, threshold,
                          scale);
    if (kMask) mask[i] = from_f<T>(keep ? 1.0f : 0.0f);
  }
}

// The blocks of one wave of `kernel` on the current device: its SMs
// times the blocks of kThreads each one holds (asked once a device).
template <typename T, bool kMask>
cudaError_t wave(int* blocks) {
  static int cached[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && cached[dev] > 0) {
    *blocks = cached[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, dropout_pass<T, kMask>, kThreads, 0);
  if (err != cudaSuccess) return err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < 64) cached[dev] = *blocks;
  return cudaSuccess;
}

template <typename T, bool kMask>
cudaError_t launch(const void* src, void* y, void* mask, long long n,
                   const void* seed, uint32_t threshold, float scale,
                   int upscale, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const uintptr_t align =
      (uintptr_t)src | (uintptr_t)y | (kMask ? (uintptr_t)mask : 0);
  const long long nvec = align % 16 == 0 ? n / kVec : 0;
  const long long work = nvec + (n - nvec * kVec);
  int most = 0;
  cudaError_t err = wave<T, kMask>(&most);
  if (err != cudaSuccess) return err;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > most) blocks = most;
  dropout_pass<T, kMask><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const T*)src, (T*)y, (T*)mask, n, nvec, (const long long*)seed,
      threshold, scale, upscale);
  return cudaGetLastError();
}

template <bool kMask>
int run(const void* src, void* y, void* mask, long long n, int dtype,
        const void* seed, unsigned threshold, float scale, int upscale,
        void* stream) {
  if (n <= 0) return 0;
  if (n >= (1LL << 31) || threshold > (1u << 24))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float, kMask>(src, y, mask, n, seed, threshold, scale,
                                     upscale, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16, kMask>(src, y, mask, n, seed,
                                             threshold, scale, upscale, s);
  return (int)cudaErrorInvalidValue;
}

__global__ void empty_kernel() {}

}  // namespace

// x, out: [n] contiguous, f32 (dtype 0) or bf16 (dtype 1); mask: the
// same, or NULL where nothing reads Mask (then it is not written); seed:
// a 0-d int64 on the device; threshold: the 24-bit keep threshold
// round((1 - p) * 2**24); scale: max(1 - p, 1e-8) as f32; upscale: 1 for
// upscale_in_train, 0 for downgrade_in_infer.  n < 2**31.  Returns the
// CUDA error of the launch (0 on success).
extern "C" int dropout_mask(const void* x, void* out, void* mask, long long n,
                            int dtype, const void* seed, unsigned threshold,
                            float scale, int upscale, void* stream) {
  if (mask == nullptr)
    return run<false>(x, out, nullptr, n, dtype, seed, threshold, scale,
                      upscale, stream);
  return run<true>(x, out, mask, n, dtype, seed, threshold, scale, upscale,
                   stream);
}

// The gradient: dx = the op's formula of g under the keep bits of
// (seed, threshold), as dropout_mask draws them.  The same arguments
// with g in place of x and dx in place of out.
extern "C" int dropout_grad(const void* g, void* dx, long long n, int dtype,
                            const void* seed, unsigned threshold, float scale,
                            int upscale, void* stream) {
  return run<false>(g, dx, nullptr, n, dtype, seed, threshold, scale,
                    upscale, stream);
}

// An empty kernel on `blocks` blocks of 256 threads: what a launch and
// its timer cost with no work, for the measurements beside the kernels
// (chip_smoke.py phase 8).
extern "C" int dropout_empty(int blocks, void* stream) {
  empty_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// The blocks of the wave the forward launches without Mask in `dtype`.
extern "C" int dropout_wave(int dtype, int* blocks) {
  if (dtype == 0) return (int)wave<float, false>(blocks);
  if (dtype == 1) return (int)wave<__nv_bfloat16, false>(blocks);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
