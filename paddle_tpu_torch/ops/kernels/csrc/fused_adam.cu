// Multi-tensor Adam / AdamW for Hopper (sm_90a): one launch updates a
// whole run of parameters, their moments in place.
//
// Replaces: paddle_tpu/ops/pallas/fused_optimizer.py:97 `_adam_kernel`
// (`apply` :166, pallas_call :208), which the JAX executor's run
// grouping (`_fused_opt_run`) calls for each contiguous run of
// same-hyperparameter adam/adamw ops.
//
// Bound on the H100 at BERT-base pretraining (153 tensors, ~132M f32
// elements): bytes.  Each element reads p, g, m1, m2 and writes p, m1,
// m2: 28 bytes, some 3.7 GB a step, ~1.1 ms at 3.35 TB/s; the dozen
// operations an element are far below the f32 rate.
//
// Design: the TPU kernel packs every tensor into padded (32, 128) slabs
// and unpacks the results, copies that exist for the TPU's tiling.
// Here a device table holds each tensor's pointers (param, grad, both
// moments, its learning rate and beta powers), its size and the first
// block that serves it; each block of 256 threads finds its tensor by
// binary search over those first blocks and updates a chunk of 8192
// elements in place, coalesced.  The expressions follow `_adam_kernel`
// (:105-115) in the same order, and the library is built with
// --fmad=false so no multiply-add is contracted: every operation rounds
// as the plain PyTorch version's separate kernels do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 8192;  // elements per block

// one row of the device table; every field is 8 bytes, so a row is the
// [10] int64 row the wrapper writes
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

__global__ void __launch_bounds__(kThreads)
    fused_adam(const Tensor* __restrict__ table, int n_tensors, float beta1,
               float beta2, float one_minus_beta1, float one_minus_beta2,
               float epsilon, float coeff) {
  const long long blk = blockIdx.x;
  int lo = 0, hi = n_tensors - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table[mid].first_block <= blk) lo = mid; else hi = mid - 1;
  }
  const Tensor t = table[lo];
  const long long start = (blk - t.first_block) * kChunk;
  const long long end = min(start + kChunk, t.n);
  const float lr = *t.lr;
  const float b1p = *t.beta1_pow;
  const float b2p = *t.beta2_pow;
  const float lr_t = lr * sqrtf(1.f - b2p * beta2) / (1.f - b1p * beta1);
#pragma unroll 4
  for (long long i = start + threadIdx.x; i < end; i += kThreads) {
    const float g = t.g[i];
    const float p = t.p[i];
    const float m1 = beta1 * t.m1[i] + one_minus_beta1 * g;
    const float m2 = beta2 * t.m2[i] + one_minus_beta2 * g * g;
    float pn = p - lr_t * m1 / (sqrtf(m2) + epsilon);
    if (coeff != 0.f) pn = pn - lr * coeff * p;
    t.p[i] = pn;
    t.m1[i] = m1;
    t.m2[i] = m2;
  }
}

}  // namespace

// table: [n_tensors, 10] int64 on the device (see Tensor), rows ordered
// by first_block, which starts at 0 and advances by ceil(n / 8192) a
// tensor; blocks: the total.  one_minus_beta*: 1 - beta computed in
// double and rounded to f32, as a JAX f32 expression rounds it.  coeff:
// the AdamW decay (0 for Adam).  Returns the CUDA error of the launch.
extern "C" int fused_adam_update(const void* table, int n_tensors,
                                 long long blocks, float beta1, float beta2,
                                 float one_minus_beta1,
                                 float one_minus_beta2, float epsilon,
                                 float coeff, void* stream) {
  if (n_tensors <= 0 || blocks <= 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  fused_adam<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const Tensor*)table, n_tensors, beta1, beta2, one_minus_beta1,
      one_minus_beta2, epsilon, coeff);
  return (int)cudaGetLastError();
}

extern "C" long long fused_adam_chunk() { return kChunk; }

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
