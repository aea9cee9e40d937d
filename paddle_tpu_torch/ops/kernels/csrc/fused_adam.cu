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
// block that serves it; each block of 512 threads updates one tile of
// 8192 elements of one tensor in place.  A block finds its tensor with
// one parallel read of the table (a barrier count of the rows whose
// first block is not past it), not a chain of dependent loads.  The
// stream is moved as 16-byte vectors: each thread loads four vectors of
// each of p, g, m1 and m2 into registers (256 bytes) before any
// arithmetic, so the loads are in flight together whatever the pointers
// alias.  Measured on the H100, that beat two vectors a thread and 256
// threads a block, and the streaming (evict-first) cache hints made it
// slower.  A tensor whose four pointers share their offset within
// 16 bytes has its tiles cut at that offset, so every tile's body is
// aligned; its first 0-3 and last 0-3 elements are scalar, in the same
// block.  A tensor whose pointers differ in that offset (views of
// unaligned storage) takes the scalar loop over all of its tiles.  The
// expressions follow `_adam_kernel` (:105-115) in the same order, and
// the library is built with --fmad=false so no multiply-add is
// contracted: every operation rounds as the plain PyTorch version's
// separate kernels do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kItems = 4;           // vectors of each stream a thread stages
constexpr long long kChunk = 8192;  // elements per block (a tile)

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

struct Hyper {
  float beta1, beta2, one_minus_beta1, one_minus_beta2, epsilon, coeff;
};

// one element in `_adam_kernel`'s order; p is read before it is written
__device__ __forceinline__ void adam_one(float& p, float g, float& m1,
                                         float& m2, float lr, float lr_t,
                                         const Hyper& h) {
  m1 = h.beta1 * m1 + h.one_minus_beta1 * g;
  m2 = h.beta2 * m2 + h.one_minus_beta2 * g * g;
  float pn = p - lr_t * m1 / (sqrtf(m2) + h.epsilon);
  if (h.coeff != 0.f) pn = pn - lr * h.coeff * p;
  p = pn;
}

__device__ __forceinline__ void adam_scalar(const Tensor& t, long long i,
                                            float lr, float lr_t,
                                            const Hyper& h) {
  float p = t.p[i], m1 = t.m1[i], m2 = t.m2[i];
  adam_one(p, t.g[i], m1, m2, lr, lr_t, h);
  t.p[i] = p;
  t.m1[i] = m1;
  t.m2[i] = m2;
}

__device__ __forceinline__ void adam_vec(float4& p, const float4& g,
                                         float4& m1, float4& m2, float lr,
                                         float lr_t, const Hyper& h) {
  adam_one(p.x, g.x, m1.x, m2.x, lr, lr_t, h);
  adam_one(p.y, g.y, m1.y, m2.y, lr, lr_t, h);
  adam_one(p.z, g.z, m1.z, m2.z, lr, lr_t, h);
  adam_one(p.w, g.w, m1.w, m2.w, lr, lr_t, h);
}

__global__ void __launch_bounds__(kThreads)
    fused_adam(const Tensor* __restrict__ table, int n_tensors, Hyper h) {
  const long long blk = blockIdx.x;
  // the rows whose first block is not past this one are a prefix (rows
  // are ordered by first_block); the last of them is this block's
  // tensor, an empty tensor sharing its first block with the next
  int rows = 0;
  for (int base = 0; base < n_tensors; base += kThreads) {
    const int i = base + threadIdx.x;
    rows += __syncthreads_count(i < n_tensors &&
                                table[i].first_block <= blk);
  }
  const Tensor t = table[rows - 1];
  const float lr = *t.lr;
  const float b1p = *t.beta1_pow;
  const float b2p = *t.beta2_pow;
  const float lr_t =
      lr * sqrtf(1.f - b2p * h.beta2) / (1.f - b1p * h.beta1);

  // tiles are cut at the tensor's common 16-byte offset (head elements
  // before the first aligned one); vb..ve is this tile's vector body
  const uintptr_t a = (uintptr_t)t.p;
  const bool vec = (((a ^ (uintptr_t)t.g) | (a ^ (uintptr_t)t.m1) |
                     (a ^ (uintptr_t)t.m2)) & 15) == 0;
  const long long head = vec ? min((long long)((16 - (a & 15)) & 15) >> 2,
                                   t.n) : 0;
  const long long j = blk - t.first_block;
  const long long start = j == 0 ? 0 : min(head + j * kChunk, t.n);
  const long long end = min(head + (j + 1) * kChunk, t.n);
  const long long vb = vec ? max(start, head) : end;
  const long long ve = vb + ((end - vb) & ~3LL);

  for (long long i = start + threadIdx.x; i < vb; i += kThreads)
    adam_scalar(t, i, lr, lr_t, h);
  for (long long i = ve + threadIdx.x; i < end; i += kThreads)
    adam_scalar(t, i, lr, lr_t, h);

  float4* P = reinterpret_cast<float4*>(t.p + vb);
  const float4* G = reinterpret_cast<const float4*>(t.g + vb);
  float4* M1 = reinterpret_cast<float4*>(t.m1 + vb);
  float4* M2 = reinterpret_cast<float4*>(t.m2 + vb);
  const int nvec = (int)((ve - vb) >> 2);
  for (int v0 = threadIdx.x; v0 < nvec; v0 += kThreads * kItems) {
    float4 p[kItems], g[kItems], m1[kItems], m2[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int v = v0 + k * kThreads;
      if (v < nvec) {
        p[k] = P[v];
        g[k] = G[v];
        m1[k] = M1[v];
        m2[k] = M2[v];
      }
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int v = v0 + k * kThreads;
      if (v < nvec) {
        adam_vec(p[k], g[k], m1[k], m2[k], lr, lr_t, h);
        P[v] = p[k];
        M1[v] = m1[k];
        M2[v] = m2[k];
      }
    }
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
  const Hyper h = {beta1, beta2, one_minus_beta1, one_minus_beta2, epsilon,
                   coeff};
  fused_adam<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const Tensor*)table, n_tensors, h);
  return (int)cudaGetLastError();
}

extern "C" long long fused_adam_chunk() { return kChunk; }

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
