// Multi-block stable LSD radix sort of int32 keys with their int32
// positions for Hopper (sm_90a), over only the key bits a table of
// nrows rows needs: the ids (int64 or int32, any values) are clipped
// into [0, nrows) and sorted ascending, equal ids in their order.  Used
// by the sparse Adagrad row update (embedding_update.cu); the
// scatter-add's one-block sort (embedding_scatter.cu) shares its
// ranking helpers (embedding_common.cuh).
//
//   1. histogram: the ids read once, clipped, and the digits of every
//      pass counted at once, a partial count per block; the same launch
//      zeroes the first pass's look-back words and the passes' tickets.
//   2. one onesweep pass per digit (20 key bits at 1,000,001 rows: 3
//      passes of 7, 7 and 6 bits).  A block takes a 1024-key tile in
//      ticket order, ranks its digits in shared memory (within a warp by
//      ballots, across warps by one scan of the per-warp counts),
//      publishes its digit counts and finds the count of each digit in
//      the tiles before it by decoupled look-back (kWindow words in
//      flight a digit), then writes the tile, sorted by digit in shared
//      memory, to each digit's range in order.  Pass 0 reads the ids
//      themselves, so the clip and the cast cost no pass.  Tiles are
//      taken in ticket order, so the look-back cannot wait on a tile
//      that has not started.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "embedding_common.cuh"

namespace {

constexpr int kSortThreads = 256;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kIPT = 4;                       // keys a thread holds
constexpr int kTile = kSortThreads * kIPT;    // keys a pass block ranks
constexpr int kMaxDigitBits = 8;
constexpr int kMaxDigits = 1 << kMaxDigitBits;
constexpr int kCntLd = kSortWarps + 1;        // per-(digit, warp) counts
constexpr int kMaxPasses = 4;                 // 31 bits / 8
constexpr int kHistThreads = 512;
constexpr int kHistIds = 8;                   // ids a histogram thread loads
constexpr int kHistChunk = kHistThreads * kHistIds;
constexpr int kMaxHistBlocks = 32;
constexpr int kWindow = 16;                   // look-back words in flight
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;
constexpr unsigned long long kFlags = ~0xffffffffull;

struct SortPlan {
  int bits;    // key bits: those of nrows - 1, at least 1
  int passes;  // ceil(bits / 8)
  int width;   // digit bits a pass: ceil(bits / passes)
};

SortPlan sort_plan(long long nrows) {
  SortPlan p;
  p.bits = 1;
  while (p.bits < 31 && ((nrows - 1) >> p.bits) != 0) ++p.bits;
  p.passes = (p.bits + kMaxDigitBits - 1) / kMaxDigitBits;
  p.width = (p.bits + p.passes - 1) / p.passes;
  return p;
}

long long align4(long long words) { return (words + 3) & ~3LL; }

// The sort's workspace, in int32 words: the sorted keys and positions
// first (n4 = n rounded up to 4 words each), the other pair of
// buffers, the histogram partials, two look-back buffers (u64 words)
// and the pass tickets; `words` in all.
struct SortLayout {
  long long n4, tiles, keys1, part, status0, status1, tickets, words;
};

SortLayout sort_layout(long long n) {
  SortLayout l;
  l.n4 = align4(n);
  l.tiles = (n + kTile - 1) / kTile;
  l.keys1 = 2 * l.n4;
  l.part = 4 * l.n4;
  l.status0 = l.part + align4((long long)kMaxHistBlocks * kMaxPasses *
                              kMaxDigits);
  l.status1 = l.status0 + 2 * l.tiles * kMaxDigits;
  l.tickets = l.status1 + 2 * l.tiles * kMaxDigits;
  l.words = l.tickets + align4(kMaxPasses);
  return l;
}

// Digit counts of every pass over this block's share of the ids, one
// partial [passes][kMaxDigits] a block.  Also zeroes the first pass's
// look-back words and the pass tickets.
__global__ void __launch_bounds__(kHistThreads)
    sort_histogram(const void* __restrict__ ids, int id_bytes, int n,
                   int nrows, int passes, int width,
                   unsigned* __restrict__ part,
                   unsigned long long* __restrict__ status0,
                   long long status_words, unsigned* __restrict__ tickets) {
  __shared__ unsigned hist[kMaxPasses * kMaxDigits];
  const int tid = threadIdx.x;
  for (int i = tid; i < passes * kMaxDigits; i += kHistThreads) hist[i] = 0;
  for (long long i = (long long)blockIdx.x * kHistThreads + tid;
       i < status_words; i += (long long)gridDim.x * kHistThreads)
    status0[i] = 0;
  if (blockIdx.x == 0 && tid < kMaxPasses) tickets[tid] = 0;
  __syncthreads();
  const unsigned mask = (1u << width) - 1u;
  for (long long base = (long long)blockIdx.x * kHistChunk; base < n;
       base += (long long)gridDim.x * kHistChunk) {
    unsigned key[kHistIds];
#pragma unroll
    for (int u = 0; u < kHistIds; ++u) {
      const long long i = base + u * kHistThreads + tid;
      key[u] = i < n ? clipped_id(ids, id_bytes, i, nrows) : 0xffffffffu;
    }
#pragma unroll
    for (int u = 0; u < kHistIds; ++u)
      if (key[u] != 0xffffffffu)
        for (int p = 0; p < passes; ++p)
          atomicAdd(&hist[p * kMaxDigits + ((key[u] >> (p * width)) & mask)],
                    1u);
  }
  __syncthreads();
  for (int i = tid; i < passes * kMaxDigits; i += kHistThreads)
    part[(long long)blockIdx.x * passes * kMaxDigits + i] = hist[i];
}

__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* p) {
  return *(const volatile unsigned long long*)p;
}

__device__ __forceinline__ void store_word(unsigned long long* p,
                                           unsigned long long v) {
  *(volatile unsigned long long*)p = v;
}

// The count of digit d in the tiles before `tile`: the tiles' words read
// kWindow at a time, newest first, aggregates added up to the first
// inclusive prefix; a word not yet published is read again.
__device__ __forceinline__ unsigned look_back(
    const unsigned long long* status, int tile, int d) {
  unsigned excl = 0;
  int j = tile - 1;
  while (true) {
    unsigned long long word[kWindow];
#pragma unroll
    for (int u = 0; u < kWindow; ++u)
      word[u] = j - u >= 0
                    ? load_word(status + (long long)(j - u) * kMaxDigits + d)
                    : kInclusive;
    int u = 0;
#pragma unroll
    for (; u < kWindow; ++u) {
      const unsigned long long flag = word[u] & kFlags;
      if (flag == 0) {
        if (u == 0) __nanosleep(32);  // the newest word is not out yet
        break;
      }
      excl += (unsigned)word[u];
      if (flag == kInclusive) return excl;
    }
    j -= u;
  }
}

// Exclusive scan of x over the block's first kMaxDigits threads (the
// others pass 0 and get 0); every thread of the block calls it.
__device__ __forceinline__ unsigned digit_scan(unsigned x,
                                               unsigned* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31 && warp < kMaxDigits / 32) warp_tot[warp] = incl;
  __syncthreads();
  unsigned before = 0;
  for (int w = 0; w < warp && w < kMaxDigits / 32; ++w) before += warp_tot[w];
  __syncthreads();
  return threadIdx.x < kMaxDigits ? before + incl - x : 0u;
}

// One stable LSD pass over the digit (key >> shift) & (2^width - 1),
// the block's tile taken in ticket order: [tile * kTile, + kTile).  Warp
// w holds keys w * 32 * kIPT .. + 32 * kIPT - 1 of the tile, kIPT rounds
// of 32 lanes, so ranks within a warp follow the keys' order.  Pass 0
// reads the ids (clipped; positions = indices), later passes the keys
// and positions of the pass before.  The tile is sorted by digit in
// shared memory first, so its writes to each digit's range are
// contiguous.  Each tile zeroes its row of the look-back words of the
// next pass.
__global__ void __launch_bounds__(kSortThreads)
    sort_pass(const void* __restrict__ ids, int id_bytes,
              const unsigned* __restrict__ keys_in,
              const unsigned* __restrict__ vals_in,
              unsigned* __restrict__ keys_out,
              unsigned* __restrict__ vals_out, int n, int nrows, int pass,
              int passes, int width, int bits,
              const unsigned* __restrict__ part, int hist_blocks,
              unsigned long long* status, unsigned long long* next_status,
              unsigned* ticket) {
  __shared__ unsigned cnt[kMaxDigits * kCntLd];
  __shared__ unsigned local_s[kMaxDigits];  // a digit's first slot in the tile
  __shared__ unsigned out_s[kMaxDigits];    // its global first slot - local_s
  __shared__ unsigned tile_keys[kTile], tile_vals[kTile];
  __shared__ unsigned warp_tot[kMaxDigits / 32];
  __shared__ int tile_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int shift = pass * width;
  const int dbits = min(width, bits - shift);
  const int nd = 1 << dbits;
  const unsigned mask = (1u << width) - 1u;
  if (tid == 0) tile_s = (int)atomicAdd(ticket, 1u);
  // this pass's total of each digit, from the histogram's partials
  unsigned total = 0;
  if (tid < nd) {
    unsigned x[kMaxHistBlocks];
#pragma unroll
    for (int b = 0; b < kMaxHistBlocks; ++b)
      x[b] = b < hist_blocks
                 ? part[((long long)b * passes + pass) * kMaxDigits + tid]
                 : 0u;
#pragma unroll
    for (int b = 0; b < kMaxHistBlocks; ++b) total += x[b];
  }
  for (int i = tid; i < nd * kCntLd; i += kSortThreads) cnt[i] = 0;
  __syncthreads();
  const int tile = tile_s;
  if (tid < kMaxDigits)
    next_status[(long long)tile * kMaxDigits + tid] = 0;
  const long long first = (long long)tile * kTile + warp * 32 * kIPT + lane;
  const int in_tile = (int)min((long long)kTile, n - (long long)tile * kTile);
  unsigned key[kIPT], val[kIPT];
#pragma unroll
  for (int r = 0; r < kIPT; ++r) {
    const long long i = first + r * 32;
    const bool ok = i < n;
    if (pass == 0) {
      key[r] = ok ? clipped_id(ids, id_bytes, i, nrows) : 0u;
      val[r] = (unsigned)i;
    } else {
      key[r] = ok ? keys_in[i] : 0u;
      val[r] = ok ? vals_in[i] : 0u;
    }
  }
  const unsigned gstart = digit_scan(total, warp_tot);
  const unsigned lt = (1u << lane) - 1u;
  unsigned dig[kIPT], rank[kIPT];
#pragma unroll
  for (int r = 0; r < kIPT; ++r) {
    const bool ok = first + r * 32 < n;
    dig[r] = (key[r] >> shift) & mask;
    // lanes holding a key of this lane's digit (none past n)
    const unsigned live = __ballot_sync(0xffffffffu, ok);
    const unsigned peers =
        digit_peers<kMaxDigitBits>(dig[r], dbits, ok ? live : ~live);
    unsigned* h = cnt + dig[r] * kCntLd + warp;
    const unsigned before = ok ? *h : 0u;
    rank[r] = before + __popc(peers & lt);
    __syncwarp();
    if (ok && (peers & lt) == 0) *h = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // the warps' first slots within each digit, and the tile's count,
  // published for the tiles after this one
  unsigned agg = 0;
  if (tid < nd) {
    unsigned c[kSortWarps];
#pragma unroll
    for (int w = 0; w < kSortWarps; ++w) c[w] = cnt[tid * kCntLd + w];
#pragma unroll
    for (int w = 0; w < kSortWarps; ++w) {
      cnt[tid * kCntLd + w] = agg;
      agg += c[w];
    }
    store_word(status + (long long)tile * kMaxDigits + tid,
               (tile == 0 ? kInclusive : kAggregate) | agg);
  }
  const unsigned local = digit_scan(agg, warp_tot);
  if (tid < nd) local_s[tid] = local;
  __syncthreads();
  // the tile sorted by digit in shared memory (stable)
#pragma unroll
  for (int r = 0; r < kIPT; ++r) {
    if (first + r * 32 < n) {
      const unsigned at = local_s[dig[r]] + cnt[dig[r] * kCntLd + warp] +
                          rank[r];
      tile_keys[at] = key[r];
      tile_vals[at] = val[r];
    }
  }
  if (tid < nd) {
    unsigned excl = 0;
    if (tile > 0) {
      excl = look_back(status, tile, tid);
      store_word(status + (long long)tile * kMaxDigits + tid,
                 kInclusive | (unsigned)(excl + agg));
    }
    out_s[tid] = gstart + excl - local;
  }
  __syncthreads();
  for (int i = tid; i < in_tile; i += kSortThreads) {
    const unsigned k = tile_keys[i];
    const unsigned at = out_s[(k >> shift) & mask] + i;
    keys_out[at] = k;
    vals_out[at] = tile_vals[i];
  }
}

// ids [n] (id_bytes 8: int64, 4: int32), 0 < n, nrows < 2**31; work:
// sort_layout(n).words int32 words, 16-byte aligned.  Leaves the clipped
// ids sorted in work[0, n) and their positions in work[n4, n4 + n).
// Returns the error of the launches.
cudaError_t radix_sort(const void* ids, int id_bytes, int n, int nrows,
                       unsigned* work, cudaStream_t s) {
  const SortPlan p = sort_plan(nrows);
  const SortLayout l = sort_layout(n);
  unsigned long long* status[2] = {(unsigned long long*)(work + l.status0),
                                   (unsigned long long*)(work + l.status1)};
  unsigned* tickets = work + l.tickets;
  const long long spread = (n + kHistChunk - 1) / kHistChunk;
  const int hist_blocks = (int)(spread < kMaxHistBlocks ? spread
                                                        : kMaxHistBlocks);
  sort_histogram<<<hist_blocks, kHistThreads, 0, s>>>(
      ids, id_bytes, n, nrows, p.passes, p.width, work + l.part, status[0],
      l.tiles * kMaxDigits, tickets);
  cudaError_t e = cudaGetLastError();
  // pass q writes the pair (passes - 1 - q) % 2, so the last writes pair 0
  for (int q = 0; q < p.passes && e == cudaSuccess; ++q) {
    const int out = (p.passes - 1 - q) & 1;
    unsigned* keys_out = work + (out ? l.keys1 : 0);
    unsigned* keys_in = work + (out ? 0 : l.keys1);
    sort_pass<<<(unsigned)l.tiles, kSortThreads, 0, s>>>(
        ids, id_bytes, keys_in, keys_in + l.n4, keys_out, keys_out + l.n4,
        n, nrows, q, p.passes, p.width, p.bits, work + l.part, hist_blocks,
        status[q & 1], status[(q + 1) & 1], tickets + q);
    e = cudaGetLastError();
  }
  return e;
}

}  // namespace
