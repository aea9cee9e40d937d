// Embedding scatter-add for Hopper (sm_90a): the gather's backward.
//   out[id, :] = sum of g[i, :] over the positions i whose id is `id`,
// summed in sorted (stable) order, into a [V, D] table zeroed by the
// caller; rows no id touches stay zero.
//
// Replaces: paddle_tpu/ops/pallas/embedding.py:65 `_scatter_kernel`
// (`scatter_add` :97, pallas_call :105), the cotangent of
// `embedding_lookup`.  As there, the ids are sorted outside the kernel
// (a stable sort, so equal ids keep their order) and the duplicates of
// an id are summed left to right: the first visit takes g, every later
// one adds to it.  No float atomics, so the result is bitwise the plain
// version's and the same on every run.
//
// Bound on the H100 at BERT-base (4096 ids, D = 768, f32): bytes.  The
// gradient rows (12.6 MB) are read once and the touched rows written
// once; the caller's zeroing of the table (94 MB for 30522 rows) is the
// larger share of the traffic.
//
// Design: one block per (sorted position, 256-column slice).  A block
// whose position starts a run of equal ids finds the run's end by
// binary search and sums each of its columns in one thread, reading
// the gradient rows through the
// sort permutation (no gathered copy of g); every other block returns
// at once.  Long runs are split across the D columns, not across rows:
// BERT's 2-row sentence table gets all of a batch's ids on row 0, so
// that row is one run of 4096 rows summed by 768 threads in 3 blocks,
// each thread reading a coalesced column, 8 rows' loads in flight at a
// time (the adds stay in sorted order).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 8;  // loads in flight per thread along a run

__global__ void __launch_bounds__(kThreads)
    scatter_add_sorted(const long long* __restrict__ sids,
                       const long long* __restrict__ order,
                       const float* __restrict__ g, float* __restrict__ out,
                       long long n, long long d) {
  const long long i = blockIdx.x;
  const long long id = sids[i];
  if (i > 0 && sids[i - 1] == id) return;  // not the start of a run
  // the run ends at the first sorted id above `id`: binary search
  long long end = i + 1, hi = n;
  while (end < hi) {
    const long long mid = (end + hi) >> 1;
    if (sids[mid] == id) end = mid + 1; else hi = mid;
  }
  for (long long c = (long long)blockIdx.y * kThreads + threadIdx.x; c < d;
       c += (long long)gridDim.y * kThreads) {
    float acc = g[order[i] * d + c];
    long long j = i + 1;
    // a long run: issue kBatch loads before adding them in order, so
    // the loads overlap while the sum keeps its sequence
    for (; j + kBatch <= end; j += kBatch) {
      float x[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) x[u] = g[order[j + u] * d + c];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) acc += x[u];
    }
    for (; j < end; ++j) acc += g[order[j] * d + c];
    out[id * d + c] = acc;
  }
}

}  // namespace

// sids: [n] int64 ids sorted ascending (stable), each in [0, V);
// order: [n] int64, the row of g at each sorted position; g: [n, d] f32
// contiguous; out: [V, d] f32 contiguous, zeroed.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int embedding_scatter_add(const long long* sids,
                                     const long long* order, const float* g,
                                     float* out, long long n, long long d,
                                     void* stream) {
  if (n <= 0 || d <= 0) return 0;
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  long long slices = (d + kThreads - 1) / kThreads;
  if (slices > 65535) slices = 65535;
  scatter_add_sorted<<<dim3((unsigned)n, (unsigned)slices), kThreads, 0,
                       (cudaStream_t)stream>>>(sids, order, g, out, n, d);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
