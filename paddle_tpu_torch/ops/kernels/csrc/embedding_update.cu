// Sparse Adagrad embedding-row update for Hopper (sm_90a): the
// optimizer step of an embedding table, applied to the rows a lookup
// touched and to no other row.
//   acc   = the sum of the gradient rows of the positions whose id is
//           `id`, in sorted (stable) order;
//   m[id] = m[id] + acc * acc;  w[id] = w[id] - lr * acc / (sqrt(m[id]) + eps)
// once per distinct id, in place.  Rows no id names are neither read nor
// written.
//
// Replaces: paddle_tpu/ops/pallas/embedding.py:165 `_update_kernel`
// (`_fused_rows_update` :187, pallas_call :197; `apply_update` :214 is
// the fused_emb_update op that AdagradOptimizer puts in place of a
// table's lookup grad + adagrad pair).  As there, the ids are clipped
// into [0, V) and stably sorted outside the kernel, and the rows of an
// id's run are summed left to right: the first visit takes g, every
// later one adds to it.  No float atomics, so the result is bitwise the
// plain version's and the same on every run.
//
// Bound on the H100 at Wide&Deep CTR training (batch 4096 x 26 fields =
// 106,496 ids, D = 16 and D = 1): bytes.  The ids (0.85 MB) and the
// gradient rows (6.8 MB) are read once and each touched row of w and m
// read and written once (~101,000 rows of the 1,000,001-row deep table
// under uniform ids, 25.9 MB): ~34 MB, ~0.01 ms at 3.35 TB/s.  The table
// itself (64 MB each for w and m) is never swept.
//
// Design: the TPU kernel walks the sorted ids one grid step at a time,
// carrying the running sum in scratch memory and writing a row when its
// id changes.  Here each sorted position gets a group of G lanes (G a
// power of two, the least that covers D, at most 32); a group whose
// position starts a run of equal ids finds the run's end by binary
// search, sums each column of the run in one lane (gradient rows read
// through the sort permutation, 8 rows' loads in flight), then applies
// Adagrad to the row; every other group returns at once.  G = 16 at
// D = 16 puts two runs in a warp, G = 1 at D = 1 (the wide table) 32.
// Built with --fmad=false: m + acc * acc and the update round as the
// plain version's separate operations do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 8;  // loads in flight per lane along a run

__global__ void __launch_bounds__(kThreads)
    adagrad_rows(const long long* __restrict__ sids,
                 const long long* __restrict__ order,
                 const float* __restrict__ g, const float* __restrict__ lr,
                 float* __restrict__ w, float* __restrict__ m, long long n,
                 long long d, float epsilon, int group) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long i = t / group;
  const int lane = (int)(t % group);
  if (i >= n) return;
  const long long id = sids[i];
  if (i > 0 && sids[i - 1] == id) return;  // not the start of a run
  // the run ends at the first sorted id above `id`: binary search
  long long end = i + 1, hi = n;
  while (end < hi) {
    const long long mid = (end + hi) >> 1;
    if (sids[mid] == id) end = mid + 1; else hi = mid;
  }
  const float rate = *lr;
  for (long long c = lane; c < d; c += group) {
    float acc = g[order[i] * d + c];
    long long j = i + 1;
    for (; j + kBatch <= end; j += kBatch) {
      float x[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) x[u] = g[order[j + u] * d + c];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) acc += x[u];
    }
    for (; j < end; ++j) acc += g[order[j] * d + c];
    const long long at = id * d + c;
    const float mn = m[at] + acc * acc;
    m[at] = mn;
    w[at] = w[at] - rate * acc / (sqrtf(mn) + epsilon);
  }
}

}  // namespace

// sids: [n] int64 ids sorted ascending (stable), each in [0, V); order:
// [n] int64, the row of g at each sorted position; g: [n, d] f32
// contiguous; lr: one f32 on the device; w, m: [V, d] f32 contiguous,
// updated in place.  Returns the CUDA error of the launch (0 on
// success).
extern "C" int embedding_adagrad_update(const long long* sids,
                                        const long long* order,
                                        const float* g, const float* lr,
                                        float* w, float* m, long long n,
                                        long long d, float epsilon,
                                        void* stream) {
  if (n <= 0 || d <= 0) return 0;
  int group = 1;
  while (group < 32 && group < d) group <<= 1;
  const long long blocks = (n * group + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  adagrad_rows<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      sids, order, g, lr, w, m, n, d, epsilon, group);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
