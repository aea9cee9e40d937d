// Embedding scatter-add for Hopper (sm_90a): the gather's backward.
//   out[id, :] = sum of g[i, :] over the positions i whose id is `id`,
// summed in sorted (stable) order, into a [V, D] table; rows no id
// touches come out zero.
//
// Replaces: paddle_tpu/ops/pallas/embedding.py:65 `_scatter_kernel`
// (`scatter_add` :97, pallas_call :105), the cotangent of
// `embedding_lookup`.  As there, the ids are clipped into [0, V) and
// stably sorted (equal ids keep their order), and the duplicates of an
// id are summed left to right: the first visit takes g, every later one
// adds to it.  No float atomics, so the result is bitwise the plain
// version's and the same on every run.
//
// Bounds on the H100 at BERT-base (4096 ids, D = 768, f32).  Bytes: the
// gradient rows (12.6 MB) read once and the whole table written once
// (94 MB for the 30522-row word table: 0.032 ms at 3.35 TB/s; 6 KB for
// the 2-row sentence table, 0.004 ms).  The add chain: the order of the
// sum is fixed, so a run of m equal ids is m - 1 dependent f32 adds a
// column; BERT's sentence table puts every id on row 0, a run of 4096,
// ~16,000 cycles at ~4 cycles an add (~0.009 ms), more than its bytes.
//
// Design, three kernels on the caller's stream:
//   1. sort: one block of 1024 threads sorts up to 8192 clipped ids
//      with their positions in shared memory, a stable LSD radix sort
//      of 8-bit digits over only the bits the row count needs (2 passes
//      for 30522 rows, 1 for 2), ranks within a warp from ballots and
//      across warps by one scan of the per-warp digit counts.  (More
//      ids: the caller sorts them with torch.sort and skips this.)
//      131 more blocks of the same launch zero the output meanwhile, on
//      other SMs, so the sort costs no time of its own on a large table.
//   2. runs: a warp for each sorted position; the one at the start of a
//      run sums it when it has at most kShort rows (lane j holds the
//      run's j-th gradient row number; 16-byte loads where D allows)
//      and writes the id's row.
//   3. long runs: the run pass lists each run of more than kShort rows
//      (an integer atomic appends it), and the long-run pass sums it
//      over ceil(D / 32) blocks, a 32-column slice each (one 128-byte
//      segment a row), on as many SMs.  In a block eight producer warps
//      bring the gradient rows in through a ring of kRing stages of 128
//      rows in shared memory (cp.async, row numbers loaded 4 stages
//      ahead), each stage signalled on an mbarrier, and one warp does
//      the adds: they read shared memory and never wait on a dependent
//      global load.  (Measured on the H100: one copying warp keeps too
//      few copies in flight to feed the chain, and 32-row stages spent
//      more on the barrier exchange than on the adds.)

#include <cuda_runtime.h>
#include <stdint.h>

#include "embedding_common.cuh"

namespace {

constexpr int kSortThreads = 1024;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSortMax = 8192;  // ids the one-block sort takes
constexpr int kShort = 32;      // longest run the run pass sums
constexpr int kStage = 128;     // gradient rows a stage of the long-run pass
constexpr int kRing = 4;        // its stages in shared memory
constexpr int kProducers = 8;   // copying warps a long-run block
constexpr int kShare = kStage / kProducers;  // rows a copying warp a stage
constexpr int kRunWarps = 8;    // warps a block of the run pass
constexpr int kRowVecs = 8;     // vectors a lane keeps in flight a row
constexpr int kFillBlocks = 131;  // zeroing blocks beside the sort's
constexpr int kDigitBits = 8;   // radix of the sort's passes
constexpr int kDigits = 1 << kDigitBits;
constexpr int kHistLd = kSortWarps + 1;

// --------------------------------------------------------------- sort

// Sorts n <= 1024 * IPT ids (clipped into [0, nrows)) with their
// positions: keys[i], order[i] for sorted position i.  Warp w owns the
// items w * 32 * IPT .. + 32 * IPT - 1, visited in index order (IPT
// rounds of 32 lanes), so ranks within a warp follow the items' order.
// Also zeroes runs[0], the long-run count of the passes after it.
// Blocks 1 .. gridDim.x - 1 meanwhile zero out[0 .. out_vecs) (16-byte
// vectors), on other SMs.
template <int IPT>
__global__ void __launch_bounds__(kSortThreads)
    sort_ids(const void* ids, int id_bytes, int n, int nrows, int passes,
             int* __restrict__ keys_out, int* __restrict__ order_out,
             int* __restrict__ runs, float4* __restrict__ out,
             long long out_vecs) {
  if (blockIdx.x > 0) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (long long v = (long long)(blockIdx.x - 1) * kSortThreads + threadIdx.x;
         v < out_vecs; v += (long long)(gridDim.x - 1) * kSortThreads)
      out[v] = z;
    return;
  }
  constexpr int kN = kSortThreads * IPT;
  extern __shared__ unsigned sort_smem[];
  unsigned* key[2] = {sort_smem, sort_smem + kN};
  unsigned* val[2] = {sort_smem + 2 * kN, sort_smem + 3 * kN};
  // per-(digit, warp) counts, digit-major, rows padded to 33 so that
  // digits 32 apart are the only ones of a warp sharing a bank
  unsigned* hist = sort_smem + 4 * kN;          // [kDigits][kHistLd]
  unsigned* warp_sum = hist + kDigits * kHistLd;  // [32] scan scratch
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) runs[0] = 0;
  for (int i = tid; i < kN; i += kSortThreads) {
    unsigned k = 0xffffffffu;  // padding sorts after every id
    if (i < n) k = clipped_id(ids, id_bytes, i, nrows);
    key[0][i] = k;
    val[0][i] = (unsigned)i;
  }
  const unsigned lt = (1u << lane) - 1u;
  // the scan's share of a thread: digit tid / 4, warps (tid % 4) * 8 ..
  unsigned* mine = hist + (tid >> 2) * kHistLd + (tid & 3) * 8;
  for (int pass = 0; pass < passes; ++pass) {
    const unsigned* ks = key[pass & 1];
    const unsigned* vs = val[pass & 1];
    unsigned* kd = key[(pass + 1) & 1];
    unsigned* vd = val[(pass + 1) & 1];
    const int shift = kDigitBits * pass;
#pragma unroll
    for (int w = 0; w < 8; ++w) mine[w] = 0;
    __syncthreads();
    unsigned rank[IPT], dig[IPT];
#pragma unroll
    for (int r = 0; r < IPT; ++r) {
      const int i = warp * 32 * IPT + r * 32 + lane;
      dig[r] = (ks[i] >> shift) & (kDigits - 1);
      const unsigned peers =
          digit_peers<kDigitBits>(dig[r], kDigitBits, 0xffffffffu);
      unsigned* h = hist + dig[r] * kHistLd + warp;
      const unsigned before = *h;
      rank[r] = before + __popc(peers & lt);
      __syncwarp();
      if ((peers & lt) == 0) *h = before + __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    // exclusive scan of hist in digit-major order: each (digit, warp)'s
    // first slot.  A thread sums its 8 entries, the block scans the
    // 1024 sums in thread order (= digit-major order), and the thread
    // writes its entries' prefixes back.
    unsigned part[8], total = 0;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      part[w] = total;
      total += mine[w];
    }
    unsigned incl = total;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const unsigned x = warp_sum[lane];
      unsigned sc = x;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(0xffffffffu, sc, o);
        if (lane >= o) sc += y;
      }
      warp_sum[lane] = sc - x;
    }
    __syncthreads();
    const unsigned base = warp_sum[warp] + incl - total;
#pragma unroll
    for (int w = 0; w < 8; ++w) mine[w] = base + part[w];
    __syncthreads();
#pragma unroll
    for (int r = 0; r < IPT; ++r) {
      const int i = warp * 32 * IPT + r * 32 + lane;
      const unsigned dst = hist[dig[r] * kHistLd + warp] + rank[r];
      kd[dst] = ks[i];
      vd[dst] = vs[i];
    }
    __syncthreads();
  }
  for (int i = tid; i < n; i += kSortThreads) {
    keys_out[i] = (int)key[passes & 1][i];
    order_out[i] = (int)val[passes & 1][i];
  }
}

// ---------------------------------------------------------- run pass

// first sorted position in [lo, hi] whose id is >= r (hi if none), found
// by the warp together: each step probes 32 evenly spaced positions and
// keeps the gap where the ids cross r, so 4096 ids take 3 dependent loads
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ keys,
                                                int lo, int hi, int r,
                                                int lane) {
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int at = lo + step * lane;
    const bool below = at < hi && keys[at] < r;
    const int cnt = __popc(__ballot_sync(0xffffffffu, below));
    if (cnt == 0) return lo;
    hi = min(hi, lo + step * cnt);
    lo = lo + step * (cnt - 1) + 1;
  }
  const bool below = lo + lane < hi && keys[lo + lane] < r;
  return lo + __popc(__ballot_sync(0xffffffffu, below));
}

template <typename V>
__device__ __forceinline__ V vzero();
template <>
__device__ __forceinline__ float vzero<float>() { return 0.f; }
template <>
__device__ __forceinline__ float4 vzero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// V = float4 (D % 4 == 0, 16-byte aligned rows) or float: a warp per
// sorted position, lanes over a row's D / width vectors.  The warp of a
// position that starts a run (its id differs from the one before) reads
// the next 32 sorted ids, and with them the run's length: a run of at
// most kShort rows it sums (lane j holding the run's j-th gradient row
// number) and writes into its row; a longer one it lists for the
// long-run pass.  Every other warp returns at once.
template <typename V>
__global__ void __launch_bounds__(kRunWarps * 32)
    scatter_runs(const int* __restrict__ keys, const int* __restrict__ order,
                 const float* __restrict__ g, float* __restrict__ out, int n,
                 long long d, int* __restrict__ runs) {
  constexpr int kW = sizeof(V) / sizeof(float);
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kRunWarps + (threadIdx.x >> 5);
  if (i >= n) return;
  const int id = keys[i];
  if (i > 0 && keys[i - 1] == id) return;  // not the start of a run
  const bool in = i + lane < n && keys[i + lane] == id;
  const int len = __popc(__ballot_sync(0xffffffffu, in));
  if (len == 32 && i + 32 < n && keys[i + 32] == id) {
    // longer than kShort: listed for the long-run pass, which writes it
    // (the list's order does not matter: each run is summed alone)
    const int hi = warp_lower_bound(keys, i + 33, n, id + 1, lane);
    if (lane == 0) {
      const int k = atomicAdd(runs, 1);
      runs[1 + 3 * k] = id;
      runs[2 + 3 * k] = i;
      runs[3 + 3 * k] = hi;
    }
    return;
  }
  const long long row = in ? (long long)order[i + lane] : 0;
  const long long nv = d / kW;
  const V* gv = reinterpret_cast<const V*>(g);
  V* o = reinterpret_cast<V*>(out + (long long)id * d);
  for (long long c0 = 0; c0 < nv; c0 += 32 * kRowVecs) {
    V acc[kRowVecs];
#pragma unroll
    for (int u = 0; u < kRowVecs; ++u) acc[u] = vzero<V>();
    for (int j = 0; j < len; ++j) {
      const long long src = __shfl_sync(0xffffffffu, row, j) * nv;
#pragma unroll
      for (int u = 0; u < kRowVecs; ++u) {
        const long long c = c0 + 32 * u + lane;
        if (c >= nv) continue;
        if (j == 0)
          acc[u] = gv[src + c];  // the first visit takes g
        else
          vadd(acc[u], gv[src + c]);
      }
    }
#pragma unroll
    for (int u = 0; u < kRowVecs; ++u) {
      const long long c = c0 + 32 * u + lane;
      if (c < nv) o[c] = acc[u];
    }
  }
}

// ---------------------------------------------------- long-run pass

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n"
      ::"r"(smem_addr(bar)) : "memory");
}
// arrives on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void bar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}
// spin: test_wait (the adding warp, whose wait is the critical path);
// else try_wait, which may suspend the thread until the phase completes
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity,
                                         bool suspend) {
  uint32_t done = 0;
  while (!done) {
    if (suspend)
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    else
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// Producer warp p's share of a stage: rows kShare * p .. + kShare - 1
// of the kStage it holds (the run's rows base ..), columns c0 .. c0 +
// 31, into `buf` (the share's rows of a [kStage][32] stage); rows past the
// run and columns past D are zero-filled.  `rows`: in lane j < kShare,
// the gradient row of the share's row j.  kVec: 16-byte copies, 8 lanes
// a row, 4 rows an instruction; else 4 bytes a lane, a row an
// instruction.
template <bool kVec>
__device__ __forceinline__ void issue_share(float* buf, int rows, int base,
                                            int len, const float* g,
                                            long long d, long long c0,
                                            int lane) {
  if (kVec) {
    const long long c = c0 + 4 * (lane & 7);
#pragma unroll
    for (int i = 0; i < kShare / 4; ++i) {
      const int j = (lane >> 3) + 4 * i;
      const int src_row = __shfl_sync(0xffffffffu, rows, j);
      const bool ok = base + j < len && c < d;
      const float* src = ok ? g + (long long)src_row * d + c : g;
      cp_async(buf + j * 32 + 4 * (lane & 7), src, 16, ok ? 16 : 0);
    }
  } else {
    const long long c = c0 + lane;
#pragma unroll
    for (int j = 0; j < kShare; ++j) {
      const int src_row = __shfl_sync(0xffffffffu, rows, j);
      const bool ok = base + j < len && c < d;
      const float* src = ok ? g + (long long)src_row * d + c : g;
      cp_async(buf + j * 32 + lane, src, 4, ok ? 4 : 0);
    }
  }
}

// A block of kProducers + 1 warps takes the listed long runs blockIdx.x,
// blockIdx.x + gridDim.x, ... for the columns blockIdx.y * 32 .. + 31.
// Warps 1 .. kProducers keep the ring full: each waits for a slot to be
// released and copies its kShare of a stage's kStage gradient rows into
// it (row numbers loaded 4 stages ahead), the copies arriving on the
// slot's `full` barrier as they land: eight warps keep more copies in
// flight than one may.  Warp 0 waits on `full`, adds the stage's rows to
// its columns' sums in order and releases the slot.  So the adds, the
// one chain the fixed order allows, never wait on an address, and a
// stage of 128 rows pays for one exchange of barriers.
template <bool kVec>
__global__ void __launch_bounds__(32 * (kProducers + 1))
    scatter_long(const int* __restrict__ order, const int* __restrict__ runs,
                 const float* __restrict__ g, float* __restrict__ out,
                 long long d) {
  extern __shared__ __align__(16) float ring[];  // [kRing][kStage][32]
  __shared__ __align__(8) uint64_t full[kRing], empty[kRing];
  constexpr int kSlot = kStage * 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x < kRing) {
    bar_init(full + threadIdx.x, 32 * kProducers);  // every producer lane
    bar_init(empty + threadIdx.x, 1);               // the adding warp
  }
  __syncthreads();
  const long long c0 = (long long)blockIdx.y * 32;
  const int count = runs[0];
  int done = 0;  // stages through the ring before this run
  for (int k = blockIdx.x; k < count; k += gridDim.x) {
    const int id = runs[1 + 3 * k], lo = runs[2 + 3 * k];
    const int len = runs[3 + 3 * k] - lo;
    const int stages = (len + kStage - 1) / kStage;
    if (warp > 0) {
      const int first = kShare * (warp - 1);  // its rows in a stage
      // the stage row whose number this lane holds
      const int* run = order + lo + first + lane % kShare;
      const int mine = first + lane % kShare;
      int rows[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        rows[u] = u * kStage + mine < len ? run[u * kStage] : 0;
      for (int s0 = 0; s0 < stages; s0 += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int s = s0 + u;
          if (s < stages) {
            const int t = done + s, slot = t % kRing, use = t / kRing;
            if (use > 0) bar_wait(empty + slot, (use - 1) & 1, true);
            issue_share<kVec>(ring + slot * kSlot + first * 32, rows[u],
                              s * kStage + first, len, g, d, c0, lane);
            bar_arrive_copies(full + slot);
            const int i = (s + 4) * kStage + mine;
            rows[u] = i < len ? run[(s + 4) * kStage] : 0;
          }
        }
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    } else {
      float acc = 0.f;
      for (int s = 0; s < stages; ++s) {
        const int t = done + s, slot = t % kRing;
        bar_wait(full + slot, (t / kRing) & 1, false);
        const float* buf = ring + slot * kSlot + lane;
        const int m = min(kStage, len - s * kStage);
        int j0 = 0;
        for (; j0 + 32 <= m; j0 += 32) {
          // 32 rows: the reads in flight together, then the adds
          float x[32];
#pragma unroll
          for (int j = 0; j < 32; ++j) x[j] = buf[(j0 + j) * 32];
          acc = (s == 0 && j0 == 0) ? x[0] : acc + x[0];  // first takes g
#pragma unroll
          for (int j = 1; j < 32; ++j) acc += x[j];
        }
        for (int j = j0; j < m; ++j)
          acc = (s == 0 && j == 0) ? buf[0] : acc + buf[j * 32];
        __syncwarp();
        if (lane == 0) bar_arrive(empty + slot);
      }
      if (c0 + lane < d) out[(long long)id * d + c0 + lane] = acc;
    }
    done += stages;
  }
}

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

template <int IPT>
cudaError_t launch_sort(const void* ids, int id_bytes, int n, int nrows,
                        int passes, int* keys, int* order, int* runs,
                        float4* out, long long out_vecs,
                        cudaStream_t stream) {
  static bool configured[64] = {};
  const size_t smem =
      (size_t)(4 * kSortThreads * IPT + kDigits * kHistLd + 32) *
      sizeof(unsigned);
  cudaError_t e = configure(sort_ids<IPT>, smem, configured);
  if (e != cudaSuccess) return e;
  sort_ids<IPT><<<out_vecs > 0 ? 1 + kFillBlocks : 1, kSortThreads, smem,
                  stream>>>(ids, id_bytes, n, nrows, passes, keys, order,
                            runs, out, out_vecs);
  return cudaGetLastError();
}

template <bool kVec>
cudaError_t launch_long(const int* order, const int* runs, const float* g,
                        float* out, int n, long long d, cudaStream_t stream) {
  static bool configured[64] = {};
  const size_t smem = (size_t)kRing * kStage * 32 * sizeof(float);
  cudaError_t e = configure(scatter_long<kVec>, smem, configured);
  if (e != cudaSuccess) return e;
  // at most n / (kShort + 1) long runs; a block loops over its share
  const long long slices = (d + 31) / 32;
  long long per_slice = 132 / slices;
  if (per_slice < 1) per_slice = 1;
  if (per_slice > n / (kShort + 1)) per_slice = n / (kShort + 1);
  scatter_long<kVec><<<dim3((unsigned)per_slice, (unsigned)slices),
                       32 * (kProducers + 1), smem, stream>>>(order, runs, g,
                                                              out, d);
  return cudaGetLastError();
}

}  // namespace

// ids: [n] int64 (id_bytes 8) or int32 (4), any values: they are clipped
// into [0, nrows).  n <= 8192.  Writes the clipped ids sorted ascending
// (stable) to keys [n] int32 and each sorted position's index into ids
// to order [n] int32, and zeroes runs[0] (the scratch of
// embedding_scatter_sum) and, if out is not null, out_bytes (a multiple
// of 16) at out, 16-byte aligned, in the same launch.  Returns the CUDA
// error of the launch.
extern "C" int embedding_scatter_sort(const void* ids, int id_bytes,
                                      long long n, long long nrows,
                                      int* keys, int* order, int* runs,
                                      void* out, long long out_bytes,
                                      void* stream) {
  if (n <= 0) return 0;
  if (n > kSortMax || nrows <= 0 || nrows > 0x7fffffffLL ||
      (id_bytes != 4 && id_bytes != 8) || out_bytes % 16 ||
      ((uintptr_t)out % 16))
    return (int)cudaErrorInvalidValue;
  int bits = 1;
  while (bits < 31 && ((nrows - 1) >> bits) != 0) ++bits;
  const int passes = (bits + kDigitBits - 1) / kDigitBits;
  cudaStream_t s = (cudaStream_t)stream;
  const int m = (int)n, v = (int)nrows;
  float4* o = (float4*)out;
  const long long ov = out ? out_bytes / 16 : 0;
  cudaError_t e;
  if (n <= 1024)
    e = launch_sort<1>(ids, id_bytes, m, v, passes, keys, order, runs, o, ov,
                       s);
  else if (n <= 2048)
    e = launch_sort<2>(ids, id_bytes, m, v, passes, keys, order, runs, o, ov,
                       s);
  else if (n <= 4096)
    e = launch_sort<4>(ids, id_bytes, m, v, passes, keys, order, runs, o, ov,
                       s);
  else
    e = launch_sort<8>(ids, id_bytes, m, v, passes, keys, order, runs, o, ov,
                       s);
  return (int)e;
}

// keys, order: [n] int32, the clipped ids sorted ascending (stable) and
// the row of g at each sorted position; g: [n, d] f32 contiguous; out:
// [nrows, d] f32 contiguous; runs: int32 scratch of 1 + 3 * (n / 33 + 1)
// (the long runs' list).  out and runs[0] must be zero: zeroed by
// embedding_scatter_sort, or here first with zero_out / zero_runs.
// Launches the run pass and the long-run pass; returns the first CUDA
// error.
extern "C" int embedding_scatter_sum(const int* keys, const int* order,
                                     const float* g, float* out, long long n,
                                     long long d, long long nrows, int* runs,
                                     int zero_out, int zero_runs,
                                     void* stream) {
  if (nrows <= 0 || d <= 0) return 0;
  if (n > 0x7fffffffLL || nrows > 0x7fffffffLL || (d + 31) / 32 > 65535)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
  if (zero_out)
    e = cudaMemsetAsync(out, 0, (size_t)(nrows * d) * sizeof(float), s);
  if (zero_runs && e == cudaSuccess)
    e = cudaMemsetAsync(runs, 0, sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  if (n <= 0) return 0;
  const bool vec = d % 4 == 0 && ((uintptr_t)g % 16) == 0 &&
                   ((uintptr_t)out % 16) == 0;
  const unsigned blocks = (unsigned)((n + kRunWarps - 1) / kRunWarps);
  if (vec)
    scatter_runs<float4><<<blocks, kRunWarps * 32, 0, s>>>(
        keys, order, g, out, (int)n, d, runs);
  else
    scatter_runs<float><<<blocks, kRunWarps * 32, 0, s>>>(
        keys, order, g, out, (int)n, d, runs);
  e = cudaGetLastError();
  if (e != cudaSuccess || n <= kShort) return (int)e;
  return (int)(vec ? launch_long<true>(order, runs, g, out, (int)n, d, s)
                   : launch_long<false>(order, runs, g, out, (int)n, d, s));
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
