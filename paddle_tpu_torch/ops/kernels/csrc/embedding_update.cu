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
// into [0, V) as int32 and stably sorted, and the rows of an id's run
// are summed left to right: the first visit takes g, every later one
// adds to it.  No float atomics, so the result is bitwise the plain
// version's and the same on every run.
//
// Bound on the H100 at Wide&Deep CTR training (batch 4096 x 26 fields =
// 106,496 ids, D = 16 and D = 1): bytes.  The ids (0.85 MB) and the
// gradient rows (6.8 MB) are read once and each touched row of w and m
// read and written once (~101,000 rows of the 1,000,001-row deep table
// under uniform ids, 25.9 MB): ~34 MB, ~0.01 ms at 3.35 TB/s.  The table
// itself (64 MB each for w and m) is never swept.  What the bytes leave
// out is the sort: a fixed cost of dependent steps that, at 106,496 ids,
// weighs as much as the bytes do.
//
// Design, up to seven kernels on the caller's stream, none of them a
// library's:
//   1. histogram and
//   2. one onesweep pass per digit: radix_sort.cuh's stable LSD radix
//      sort of the clipped int32 ids with their int32 positions over
//      only the bits the table needs (20 at 1,000,001 rows: a histogram
//      launch for every digit, then 3 passes of 7, 7 and 6 bits), the
//      clip and the int64/int32 read fused into the first two launches.
//   3. runs: a block takes T sorted positions and the kShort + 1 after
//      them, flags where the id changes and compacts the flags into its
//      list of runs, so a run's end is the next run's start; a group of
//      G lanes takes each run that starts in the tile (G = 4 at D = 16:
//      four 16-byte vectors a row; G = 1 at D = 1; 4-byte columns where
//      D is not a multiple of 4), loads its w and m row, sums its
//      gradient rows through the int32 positions with kBatch loads in
//      flight, and writes the row.  A run of more than kShort rows is
//      listed, with the tile's other long runs, in the tile's own slots
//      (written every call: no counter to reset), for
//   4. long runs: a block for each tile takes the tile's listed runs one
//      at a time, finds the run's end by a block-wide forward scan, and
//      streams its gradient rows through a ring of kStages
//      shared-memory stages (cp.async; their row numbers loaded a ring
//      turn ahead), a 256-column slice at a time; one thread a column
//      adds them in order, so the add chain of a column stays in one
//      thread.
// No 64-bit division, no binary search; the grids are sized from n and
// the host reads nothing back.  Built with --fmad=false: m + acc * acc
// and the update round as the plain version's separate operations do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "embedding_common.cuh"
#include "radix_sort.cuh"

namespace {

// ------------------------------------------------------------- update
constexpr int kRowThreads = 256;
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kShort = 32;      // longest run the run kernel sums
constexpr int kBatch = 8;       // gradient loads in flight a lane
constexpr int kLongThreads = 256;
constexpr int kStageFloats = 2048;  // a stage of the long-run ring
constexpr int kStages = 4;
constexpr int kWalk = 16;       // ids a thread reads a step of the end scan

// The workspace, in int32 words: the sort's (the final keys and
// positions first, what embedding_update_rows reads), then the long
// runs listed per run tile (a count a tile, then each tile's starts: at
// most n / 33 + 2n / 64 + 18 words).
struct Layout {
  SortLayout sort;
  long long list, words;
};

Layout layout_for(long long n) {
  Layout l;
  l.sort = sort_layout(n);
  l.list = l.sort.words;
  l.words = l.list + align4(n / 16 + 64);
  return l;
}

template <int VEC> struct Vec;
template <> struct Vec<1> { typedef float T; };
template <> struct Vec<4> { typedef float4 T; };

__device__ __forceinline__ void adagrad(float& w, float& m, float acc,
                                        float rate, float epsilon) {
  m = m + acc * acc;
  w = w - rate * acc / (sqrtf(m) + epsilon);
}
__device__ __forceinline__ void adagrad(float4& w, float4& m,
                                        const float4& acc, float rate,
                                        float epsilon) {
  adagrad(w.x, m.x, acc.x, rate, epsilon);
  adagrad(w.y, m.y, acc.y, rate, epsilon);
  adagrad(w.z, m.z, acc.z, rate, epsilon);
  adagrad(w.w, m.w, acc.w, rate, epsilon);
}

// sorted positions a run block takes: about two runs a group
template <int G>
struct RunTile {
  static constexpr int kT = 2 * kRowThreads / G < 64
                                ? 64
                                : (2 * kRowThreads / G > 512
                                       ? 512
                                       : 2 * kRowThreads / G);
  // positions whose run-start flag the block reads: the tile and the
  // kShort + 1 after it (enough to see whether its last run is short)
  static constexpr int kSpan = kT + kShort + 1;
  static constexpr int kRounds = (kSpan + kRowThreads - 1) / kRowThreads;
  // runs of more than kShort rows that start in the tile
  static constexpr int kLong = kT / (kShort + 1) + 1;
};

// Runs of at most kShort rows, summed and applied by a group of G lanes
// each (lanes over a row's D / VEC vectors); longer runs listed: block b
// writes their count to list[b] and their starts to list[tiles + b *
// kLong ..], every call, so the list needs no reset.
template <int G, int VEC>
__global__ void __launch_bounds__(kRowThreads)
    adagrad_runs(const int* __restrict__ keys, const int* __restrict__ order,
                 const float* __restrict__ g, const float* __restrict__ lr,
                 float* __restrict__ w, float* __restrict__ m, int n, int d,
                 float epsilon, int* __restrict__ list) {
  typedef typename Vec<VEC>::T V;
  typedef RunTile<G> Tile;
  static_assert(Tile::kRounds * kRowWarps <= 32, "one warp scans the slots");
  __shared__ int key_s[Tile::kSpan + 1];  // key_s[q + 1]: id at t0 + q
  __shared__ int start_s[Tile::kSpan];    // run starts, tile-relative
  __shared__ int slot_s[32];
  __shared__ int long_s[Tile::kLong];
  __shared__ int nstart_s, nrun_s, nlong_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = blockIdx.x * Tile::kT;
  const int span = min(Tile::kSpan, n - t0);
  const int len_t = min(Tile::kT, n - t0);
  for (int q = tid; q <= span; q += kRowThreads)
    key_s[q] = t0 + q - 1 >= 0 ? keys[t0 + q - 1] : -1;
  if (tid == 0) nrun_s = nlong_s = 0;
  __syncthreads();
  // flag the positions where the id changes; compact them in order
  unsigned flags[Tile::kRounds];
#pragma unroll
  for (int r = 0; r < Tile::kRounds; ++r) {
    const int q = r * kRowThreads + tid;
    const bool f = q < span && key_s[q + 1] != key_s[q];
    flags[r] = __ballot_sync(0xffffffffu, f);
    const unsigned in_tile = __ballot_sync(0xffffffffu, f && q < len_t);
    if (lane == 0) {
      slot_s[r * kRowWarps + warp] = __popc(flags[r]);
      if (in_tile) atomicAdd(&nrun_s, __popc(in_tile));
    }
  }
  __syncthreads();
  if (warp == 0) {
    const int x = lane < Tile::kRounds * kRowWarps ? slot_s[lane] : 0;
    int incl = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    slot_s[lane] = incl - x;
    if (lane == 31) nstart_s = incl;
  }
  __syncthreads();
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < Tile::kRounds; ++r)
    if ((flags[r] >> lane) & 1u)
      start_s[slot_s[r * kRowWarps + warp] + __popc(flags[r] & lt)] =
          r * kRowThreads + tid;
  __syncthreads();
  const int nstart = nstart_s, nrun = nrun_s;
  const bool to_n = t0 + span == n;
  const float rate = *lr;
  const int dv = d / VEC;
  const V* __restrict__ gv = (const V*)g;
  V* __restrict__ wv = (V*)w;
  V* __restrict__ mv = (V*)m;
  const int gl = tid % G;
  for (int k = tid / G; k < nrun; k += kRowThreads / G) {
    const int s = start_s[k];
    const int e = k + 1 < nstart ? start_s[k + 1] : (to_n ? span : -1);
    if (e < 0 || e - s > kShort) {
      if (gl == 0) long_s[atomicAdd(&nlong_s, 1)] = t0 + s;
      continue;
    }
    const int len = e - s;
    const int* __restrict__ pos = order + t0 + s;
    const long long row = (long long)key_s[s + 1] * dv;
    for (int c = gl; c < dv; c += G) {
      V wr = wv[row + c], mr = mv[row + c];
      V acc = gv[(long long)pos[0] * dv + c];
      int j = 1;
      for (; j + kBatch <= len; j += kBatch) {
        V x[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          x[u] = gv[(long long)pos[j + u] * dv + c];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) vadd(acc, x[u]);
      }
      for (; j < len; ++j) vadd(acc, gv[(long long)pos[j] * dv + c]);
      adagrad(wr, mr, acc, rate, epsilon);
      wv[row + c] = wr;
      mv[row + c] = mr;
    }
  }
  __syncthreads();
  const int nlong = nlong_s;
  if (tid == 0) list[blockIdx.x] = nlong;
  if (tid < nlong)
    list[gridDim.x + blockIdx.x * Tile::kLong + tid] = long_s[tid];
}

// A long run's stage k, column slice [c0, c0 + sw): rows k * rc ..
// + rc - 1 of the run (rc = kStageFloats / sw), VEC floats a copy.  A
// thread's kPer copies: their gradient row numbers are loaded one ring
// turn ahead of the copies (at), so no thread waits on them.
template <int VEC>
struct Stage {
  static constexpr int kPer = kStageFloats / (VEC * kLongThreads);

  __device__ __forceinline__ static void rows(int (&at)[kPer],
                                              const int* __restrict__ pos,
                                              int sw, int len, int k,
                                              int nstages) {
    const int rc = kStageFloats / sw;
    const int rn = k < nstages ? min(rc, len - k * rc) : 0;
    const int upr = sw / VEC;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = (int)(threadIdx.x + i * kLongThreads) / upr;
      at[i] = r < rn ? pos[k * rc + r] : -1;
    }
  }

  __device__ __forceinline__ static void copy(const int (&at)[kPer],
                                              float* ring,
                                              const float* __restrict__ g,
                                              int d, int c0, int sw, int k) {
    const int upr = sw / VEC;
    float* buf = ring + (k % kStages) * kStageFloats;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (at[i] >= 0) {
        const int u = threadIdx.x + i * kLongThreads;
        const int r = u / upr, cv = u - r * upr;
        cp_async(buf + r * sw + cv * VEC,
                 g + (long long)at[i] * d + c0 + cv * VEC, 4 * VEC, 4 * VEC);
      }
    }
    cp_commit();
  }
};

// Runs of more than kShort rows: block b takes the runs the run kernel's
// block b listed (at most `cap`), one at a time.
template <int VEC>
__global__ void __launch_bounds__(kLongThreads)
    adagrad_long_runs(const int* __restrict__ keys,
                      const int* __restrict__ order,
                      const float* __restrict__ g,
                      const float* __restrict__ lr, float* __restrict__ w,
                      float* __restrict__ m, int n, int d, float epsilon,
                      const int* __restrict__ list, int cap) {
  typedef Stage<VEC> St;
  extern __shared__ float4 ring4[];
  float* ring = (float*)ring4;
  __shared__ int end_s;
  const int tid = threadIdx.x;
  const float rate = *lr;
  const int runs = list[blockIdx.x];
  for (int run = 0; run < runs; ++run) {
    const int s = list[gridDim.x + blockIdx.x * cap + run];
    const int key = keys[s];
    if (tid == 0) end_s = n;
    __syncthreads();
    // the run's end: the first sorted position after it with another id
    // (positions s .. s + kShort all hold this id), kWalk ids a thread
    // a step
    for (int base = s + kShort + 1; base < n; base += kWalk * kLongThreads) {
      int id[kWalk];
#pragma unroll
      for (int u = 0; u < kWalk; ++u) {
        const int j = base + u * kLongThreads + tid;
        id[u] = j < n ? keys[j] : key;
      }
      int found = n;
#pragma unroll
      for (int u = kWalk - 1; u >= 0; --u)
        if (id[u] != key) found = base + u * kLongThreads + tid;
      if (found < n) atomicMin(&end_s, found);
      __syncthreads();
      const bool done = end_s < n;
      __syncthreads();
      if (done) break;
    }
    const int len = end_s - s;
    const int* __restrict__ pos = order + s;
    for (int c0 = 0; c0 < d; c0 += kLongThreads) {
      const int sw = min(d - c0, kLongThreads);
      const int rc = kStageFloats / sw;
      const int nstages = (len + rc - 1) / rc;
      const long long at_w = (long long)key * d + c0 + tid;
      float wr = 0.f, mr = 0.f, acc = 0.f;
      if (tid < sw) {
        wr = w[at_w];
        mr = m[at_w];
      }
      int at[St::kPer];
#pragma unroll
      for (int k = 0; k < kStages - 1; ++k) {
        St::rows(at, pos, sw, len, k, nstages);
        St::copy(at, ring, g, d, c0, sw, k);
      }
      St::rows(at, pos, sw, len, kStages - 1, nstages);
      for (int k = 0; k < nstages; ++k) {
        St::copy(at, ring, g, d, c0, sw, k + kStages - 1);
        St::rows(at, pos, sw, len, k + kStages, nstages);
        cp_wait<kStages - 1>();
        __syncthreads();
        if (tid < sw) {
          // the column's adds in order, the next 8 rows' loads in
          // flight during each 8 adds
          const int rn = min(rc, len - k * rc);
          const float* buf = ring + (k % kStages) * kStageFloats + tid;
          int i = 0;
          if (k == 0) {
            acc = buf[0];
            i = 1;
          }
          if (i + 8 <= rn) {
            float x[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) x[u] = buf[(i + u) * sw];
            for (i += 8; i + 8 <= rn; i += 8) {
              float y[8];
#pragma unroll
              for (int u = 0; u < 8; ++u) y[u] = buf[(i + u) * sw];
#pragma unroll
              for (int u = 0; u < 8; ++u) acc += x[u];
#pragma unroll
              for (int u = 0; u < 8; ++u) x[u] = y[u];
            }
#pragma unroll
            for (int u = 0; u < 8; ++u) acc += x[u];
          }
          for (; i < rn; ++i) acc += buf[i * sw];
        }
        __syncthreads();
      }
      if (tid < sw) {
        adagrad(wr, mr, acc, rate, epsilon);
        w[at_w] = wr;
        m[at_w] = mr;
      }
    }
  }
}

template <int G, int VEC>
cudaError_t launch_rows(const int* keys, const int* order, const float* g,
                        const float* lr, float* w, float* m, int n, int d,
                        float epsilon, int* list, cudaStream_t s) {
  const int blocks = (n + RunTile<G>::kT - 1) / RunTile<G>::kT;
  adagrad_runs<G, VEC><<<blocks, kRowThreads, 0, s>>>(
      keys, order, g, lr, w, m, n, d, epsilon, list);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n <= kShort) return e;
  constexpr size_t smem = (size_t)kStages * kStageFloats * sizeof(float);
  static_assert(smem <= 48 * 1024, "the ring needs no shared-memory opt-in");
  // a block for each run block's list (most are empty)
  adagrad_long_runs<VEC><<<blocks, kLongThreads, smem, s>>>(
      keys, order, g, lr, w, m, n, d, epsilon, list, RunTile<G>::kLong);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t launch_rows_vec(int group, const int* keys, const int* order,
                            const float* g, const float* lr, float* w,
                            float* m, int n, int d, float epsilon, int* list,
                            cudaStream_t s) {
  switch (group) {
    case 1: return launch_rows<1, VEC>(keys, order, g, lr, w, m, n, d,
                                       epsilon, list, s);
    case 2: return launch_rows<2, VEC>(keys, order, g, lr, w, m, n, d,
                                       epsilon, list, s);
    case 4: return launch_rows<4, VEC>(keys, order, g, lr, w, m, n, d,
                                       epsilon, list, s);
    case 8: return launch_rows<8, VEC>(keys, order, g, lr, w, m, n, d,
                                       epsilon, list, s);
    case 16: return launch_rows<16, VEC>(keys, order, g, lr, w, m, n, d,
                                         epsilon, list, s);
    default: return launch_rows<32, VEC>(keys, order, g, lr, w, m, n, d,
                                         epsilon, list, s);
  }
}

bool sizes_ok(long long n, long long nrows) {
  return n > 0 && n <= 0x7fffffffLL && nrows > 0 && nrows <= 0x7fffffffLL;
}

}  // namespace

// int32 words of workspace that embedding_update_sort and
// embedding_update_rows need for n ids into an nrows-row table (0 if
// the sizes are out of range).  Its first 2n words (rounded up to 4)
// hold the sorted keys, then the positions.
extern "C" long long embedding_update_workspace(long long n,
                                                long long nrows) {
  if (!sizes_ok(n, nrows)) return 0;
  return layout_for(n).words;
}

// ids: [n] int64 (id_bytes 8) or int32 (4), any values: they are clipped
// into [0, nrows).  work: embedding_update_workspace(n, nrows) int32
// words, 16-byte aligned.  Writes the clipped ids sorted ascending
// (stable) to work[0, n) and each sorted position's index into ids to
// work[n4, n4 + n), n4 = n rounded up to 4.  Returns the CUDA error of
// the launches (0 on success).
extern "C" int embedding_update_sort(const void* ids, int id_bytes,
                                     long long n, long long nrows,
                                     int* work, void* stream) {
  if (n <= 0) return 0;
  if (!sizes_ok(n, nrows) || (id_bytes != 4 && id_bytes != 8) ||
      ((uintptr_t)work % 16))
    return (int)cudaErrorInvalidValue;
  return (int)radix_sort(ids, id_bytes, (int)n, (int)nrows,
                         (unsigned*)work, (cudaStream_t)stream);
}

// work: the workspace embedding_update_sort filled for the same n and
// nrows; g: [n, d] f32 contiguous (row i for ids[i]); lr: one f32 on the
// device; w, m: [nrows, d] f32 contiguous, updated in place.  Returns
// the CUDA error of the launches (0 on success).
extern "C" int embedding_update_rows(int* work, const float* g,
                                     const float* lr, float* w, float* m,
                                     long long n, long long nrows,
                                     long long d, float epsilon,
                                     void* stream) {
  if (n <= 0 || d <= 0) return 0;
  if (!sizes_ok(n, nrows) || d > 0x7fffffffLL / 4 || ((uintptr_t)work % 16))
    return (int)cudaErrorInvalidValue;
  const Layout l = layout_for(n);
  const int* keys = work;
  const int* order = work + l.sort.n4;
  int* list = work + l.list;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = d % 4 == 0 && ((uintptr_t)g % 16) == 0 &&
                   ((uintptr_t)w % 16) == 0 && ((uintptr_t)m % 16) == 0;
  const long long units = vec ? d / 4 : d;
  int group = 1;
  while (group < 32 && group < units) group <<= 1;
  const cudaError_t e =
      vec ? launch_rows_vec<4>(group, keys, order, g, lr, w, m, (int)n,
                               (int)d, epsilon, list, s)
          : launch_rows_vec<1>(group, keys, order, g, lr, w, m, (int)n,
                               (int)d, epsilon, list, s);
  return (int)e;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
