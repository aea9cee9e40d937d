// Multi-tensor finite check for Hopper (sm_90a): one launch over a
// device table of N floating tensors writes one byte per tensor, 1 where
// every element is finite.  FLAGS_check_nan_inf's verdicts of a step.
//
// Replaces: no Pallas kernel.  The JAX package reduces isfinite().all()
// of each checked value inside its XLA segment and reads the verdicts
// once (paddle_tpu/fluid/executor.py:2578 `_check_nan_inf`); the port's
// eager path launched one isfinite + all pair per value, about a
// thousand launches a BERT-base step.
//
// Bound on the H100: bytes.  Each checked element is read once and
// nothing but N bytes is written, so the least time is the checked bytes
// over 3.35 TB/s; the bit tests are a few integer operations per
// element.
//
// Design: the wrapper writes a table row per tensor (pointer, element
// count, element kind, first block) and fills the verdicts with 1.  Each
// block of 256 threads owns one chunk of 16384 elements of one tensor
// and finds its row by a binary search over the rows' first blocks; an
// empty tensor owns no block and keeps its 1.  The chunk is read as
// 16-byte vectors where the chunk starts on 16 bytes (scalar otherwise,
// and for the tail).  An element is not finite when its exponent bits
// are all set (f32 0x7f800000, bf16 0x7f80, f16 0x7c00, f64
// 0x7ff0000000000000): integer tests on the raw bits, so no float
// arithmetic and no float atomics.  A block that finds one writes 0 to
// its tensor's byte; every writer writes the same 0, so the verdicts are
// the same whatever the blocks' order, bitwise the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 16384;

// one row of the device table: the [4] int64 row the wrapper writes
struct Row {
  const void* p;
  long long n;
  long long kind;  // 0 f32, 1 bf16, 2 f16, 3 f64
  long long first_block;
};

template <typename U>
__device__ __forceinline__ bool all_set(U v, U mask) {
  return (v & mask) == mask;
}

template <typename U>
__device__ bool scan(const void* base, long long start, long long end,
                     U mask) {
  constexpr int V = 16 / sizeof(U);
  const U* q = static_cast<const U*>(base) + start;
  long long len = end - start;
  bool bad = false;
  long long head = 0;
  if ((reinterpret_cast<uintptr_t>(q) & 15) == 0) {
    long long nvec = len / V;
    const uint4* vq = reinterpret_cast<const uint4*>(q);
#pragma unroll 4
    for (long long i = threadIdx.x; i < nvec; i += kThreads) {
      union {
        uint4 v;
        U u[V];
      } w;
      w.v = __ldg(vq + i);
#pragma unroll
      for (int k = 0; k < V; ++k) bad |= all_set<U>(w.u[k], mask);
    }
    head = nvec * V;
  }
  for (long long i = head + threadIdx.x; i < len; i += kThreads)
    bad |= all_set<U>(q[i], mask);
  return bad;
}

__global__ void __launch_bounds__(kThreads)
    finite_kernel(const Row* rows, int nrows, uint8_t* out) {
  long long b = blockIdx.x;
  int lo = 0, hi = nrows - 1;
  while (lo < hi) {
    int mid = (lo + hi + 1) / 2;
    if (rows[mid].first_block <= b)
      lo = mid;
    else
      hi = mid - 1;
  }
  Row r = rows[lo];
  long long start = (b - r.first_block) * kChunk;
  long long end = start + kChunk < r.n ? start + kChunk : r.n;
  bool bad = false;
  switch (r.kind) {
    case 0: bad = scan<uint32_t>(r.p, start, end, 0x7f800000u); break;
    case 1: bad = scan<uint16_t>(r.p, start, end, (uint16_t)0x7f80); break;
    case 2: bad = scan<uint16_t>(r.p, start, end, (uint16_t)0x7c00); break;
    case 3:
      bad = scan<unsigned long long>(r.p, start, end,
                                     0x7ff0000000000000ull);
      break;
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) out[lo] = 0;
}

}  // namespace

extern "C" int finite_check_launch(const void* rows, int nrows,
                                   long long blocks, void* out,
                                   void* stream) {
  if (blocks <= 0) return 0;
  finite_kernel<<<(unsigned int)blocks, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Row*>(rows), nrows, static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}

extern "C" long long finite_check_chunk() { return kChunk; }

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
