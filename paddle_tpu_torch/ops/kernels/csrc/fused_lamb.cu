// Multi-tensor LAMB for Hopper (sm_90a): one update of a whole run of
// parameters, their moments in place, in three kernels on one stream.
//
// Replaces: paddle_tpu/ops/pallas/fused_optimizer.py:118 `_lamb1_kernel`
// (pallas_call :219) and :139 `_lamb2_kernel` (pallas_call :234), with
// the segment sum between them (:228-233), which the JAX executor's run
// grouping (`_fused_opt_run`) calls for each contiguous run of
// same-hyperparameter lamb ops.
//
// LAMB moves a parameter along the Adam direction plus decoupled weight
// decay, r = m1hat / (sqrt(m2hat) + eps) + wd * p, scaled per tensor by
// the trust ratio ||p|| / ||r|| (1 where either norm is 0).  The norms
// are reductions over a whole tensor, so the update takes two passes
// over the elements and a per-tensor sum between them:
//   lamb_moments  each block updates m1, m2 over a chunk of one tensor
//                 and writes the chunk's partial sums of p^2 and r^2;
//   lamb_trust    one warp per tensor sums that tensor's partials, then
//                 computes its trust ratio;
//   lamb_apply    each block recomputes r from p and the new moments,
//                 as `_lamb2_kernel` does, and writes p - lr * trust * r.
//
// Bound on the H100 at BERT-base pretraining (153 tensors, ~132M f32
// elements): bytes.  The moments pass reads p, g, m1, m2 and writes m1,
// m2 (24 bytes an element); the apply pass reads p, m1, m2 and writes p
// (16 bytes): 5.3 GB a step, ~1.58 ms at 3.35 TB/s.  The partials are a
// few kilobytes.
//
// Design: the TPU kernels pack every tensor into padded (32, 128) slabs,
// copies that exist for the TPU's tiling.  Here a device table holds
// each tensor's pointers, its size and the first block that serves it
// (the layout of fused_adam.cu's table); a block finds its tensor by
// binary search and walks a chunk of 8192 elements, coalesced.  No
// float atomics: each block reduces its partial sums in a fixed tree,
// and each tensor's partials are summed by one warp in a fixed order,
// so the trust ratios, and the parameters, are the same on every run.
// The expressions follow `_lamb1_kernel` / `_lamb2_kernel` in the same
// order, and the library is built with --fmad=false, so the moments
// round as the plain PyTorch version's separate kernels do (bitwise);
// the parameters differ from it only through the norms' summation
// order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kChunk = 8192;  // elements per block

// one row of the device table: the [10] int64 row the wrapper writes
struct Tensor {
  float* p;
  const float* g;
  float* m1;
  float* m2;
  const float* lr;
  const float* beta1_pow;
  const float* beta2_pow;
  long long n;
  long long first_block;
  long long pad;
};

struct Hyper {
  float beta1, beta2, one_minus_beta1, one_minus_beta2, epsilon, decay;
};

__device__ __forceinline__ int find_tensor(const Tensor* __restrict__ table,
                                           int n_tensors, long long blk) {
  int lo = 0, hi = n_tensors - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table[mid].first_block <= blk) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// r of one element, as `_lamb1_kernel` / `_lamb2_kernel` compute it from
// the new moments
__device__ __forceinline__ float lamb_r(float m1, float m2, float p,
                                        float bc1, float bc2,
                                        const Hyper& h) {
  const float mhat = m1 / bc1;
  const float vhat = m2 / bc2;
  return mhat / (sqrtf(vhat) + h.epsilon) + h.decay * p;
}

__global__ void __launch_bounds__(kThreads)
    lamb_moments(const Tensor* __restrict__ table, int n_tensors, Hyper h,
                 float2* __restrict__ partial) {
  const long long blk = blockIdx.x;
  const Tensor t = table[find_tensor(table, n_tensors, blk)];
  const long long start = (blk - t.first_block) * kChunk;
  const long long end = min(start + kChunk, t.n);
  const float bc1 = 1.f - *t.beta1_pow * h.beta1;
  const float bc2 = 1.f - *t.beta2_pow * h.beta2;
  float sp = 0.f, sr = 0.f;
#pragma unroll 4
  for (long long i = start + threadIdx.x; i < end; i += kThreads) {
    const float g = t.g[i];
    const float p = t.p[i];
    const float m1 = h.beta1 * t.m1[i] + h.one_minus_beta1 * g;
    const float m2 = h.beta2 * t.m2[i] + h.one_minus_beta2 * g * g;
    const float r = lamb_r(m1, m2, p, bc1, bc2, h);
    t.m1[i] = m1;
    t.m2[i] = m2;
    sp += p * p;
    sr += r * r;
  }
  // the block's sums in a fixed tree: lanes by xor shuffles, then the
  // warps' sums in order
  for (int off = 16; off > 0; off >>= 1) {
    sp += __shfl_xor_sync(0xffffffffu, sp, off);
    sr += __shfl_xor_sync(0xffffffffu, sr, off);
  }
  __shared__ float2 warp_sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = make_float2(sp, sr);
  __syncthreads();
  if (threadIdx.x == 0) {
    float2 s = warp_sums[0];
    for (int w = 1; w < kWarps; ++w) {
      s.x += warp_sums[w].x;
      s.y += warp_sums[w].y;
    }
    partial[blk] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
    lamb_trust(const Tensor* __restrict__ table, int n_tensors,
               const float2* __restrict__ partial,
               float* __restrict__ trust) {
  const int ti = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (ti >= n_tensors) return;  // whole warps leave together
  const Tensor t = table[ti];
  const long long first = t.first_block;
  const long long last = first + (t.n + kChunk - 1) / kChunk;
  float sp = 0.f, sr = 0.f;
  for (long long b = first + lane; b < last; b += 32) {
    const float2 s = partial[b];
    sp += s.x;
    sr += s.y;
  }
  for (int off = 16; off > 0; off >>= 1) {
    sp += __shfl_xor_sync(0xffffffffu, sp, off);
    sr += __shfl_xor_sync(0xffffffffu, sr, off);
  }
  if (lane == 0) {
    const float pn = sqrtf(sp);
    const float rn = sqrtf(sr);
    trust[ti] = (pn > 0.f && rn > 0.f) ? pn / rn : 1.f;
  }
}

__global__ void __launch_bounds__(kThreads)
    lamb_apply(const Tensor* __restrict__ table, int n_tensors, Hyper h,
               const float* __restrict__ trust) {
  const long long blk = blockIdx.x;
  const int ti = find_tensor(table, n_tensors, blk);
  const Tensor t = table[ti];
  const long long start = (blk - t.first_block) * kChunk;
  const long long end = min(start + kChunk, t.n);
  const float bc1 = 1.f - *t.beta1_pow * h.beta1;
  const float bc2 = 1.f - *t.beta2_pow * h.beta2;
  const float step = *t.lr * trust[ti];
#pragma unroll 4
  for (long long i = start + threadIdx.x; i < end; i += kThreads) {
    const float p = t.p[i];
    t.p[i] = p - step * lamb_r(t.m1[i], t.m2[i], p, bc1, bc2, h);
  }
}

}  // namespace

// table: [n_tensors, 10] int64 on the device (see Tensor), rows ordered
// by first_block, which starts at 0 and advances by ceil(n / 8192) a
// tensor; blocks: the total.  one_minus_beta*: 1 - beta computed in
// double and rounded to f32, as a JAX f32 expression rounds it.  decay:
// the LAMB weight decay.  partial: [blocks] float2 scratch; trust:
// [n_tensors] f32, the trust ratios applied.  Returns the CUDA error of
// the launches (0 on success).
extern "C" int fused_lamb_update(const void* table, int n_tensors,
                                 long long blocks, float beta1, float beta2,
                                 float one_minus_beta1,
                                 float one_minus_beta2, float epsilon,
                                 float decay, void* partial, void* trust,
                                 void* stream) {
  if (n_tensors <= 0 || blocks <= 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const Hyper h{beta1, beta2, one_minus_beta1, one_minus_beta2, epsilon,
                decay};
  const cudaStream_t s = (cudaStream_t)stream;
  const Tensor* tab = (const Tensor*)table;
  lamb_moments<<<(unsigned)blocks, kThreads, 0, s>>>(tab, n_tensors, h,
                                                     (float2*)partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lamb_trust<<<(unsigned)((n_tensors + kWarps - 1) / kWarps), kThreads, 0,
               s>>>(tab, n_tensors, (const float2*)partial, (float*)trust);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lamb_apply<<<(unsigned)blocks, kThreads, 0, s>>>(tab, n_tensors, h,
                                                   (const float*)trust);
  return (int)cudaGetLastError();
}

extern "C" long long fused_lamb_chunk() { return kChunk; }

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
