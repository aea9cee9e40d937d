// Flash-attention forward for Hopper (sm_90a):
//   O = softmax(Q K^T * scale + key_bias [+ causal mask]) V, and the
//   per-row log-sum-exp lse, without a [T, T] score matrix in memory.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py:121
// `_flash_fwd_kernel` (launcher `_flash_fwd` :558, pallas_call :585),
// the Pallas TPU kernel behind `flash_attention` / `flash_attention_with_lse`.
//
// Bound on the H100 at BERT-base serving (B=8, H=12, T=512, D=64, f32):
// operations.  The two products take 4*B*H*T^2*D = 6.4 GFLOP, about
// 96 us at the 67 TFLOP/s of f32 arithmetic outside the tensor cores,
// while Q, K, V, O, the bias and lse are about 50 MB, 15 us at
// 3.35 TB/s.  The kernel computes in full f32 (no TF32), so the f32
// FMA rate is the ceiling it is held to.
//
// Design: one thread block of 128 threads per (batch*head, 64-row Q
// tile).  K and V stream through shared memory in 64-key tiles; the
// online softmax keeps the running max, the normalizer and the 64 x D
// output accumulator in f32 registers, so scores never leave the SM.
// Each thread owns 4 query rows x 8 key columns of a score tile and
// 4 rows x D/8 output columns; Q, K and P are kept transposed in
// shared memory so a thread reads its 4 rows as one 16-byte vector and
// neighbouring threads read neighbouring keys (no bank conflicts on the
// reads).  Row max and row sum reduce over the 8 threads of a row with
// warp shuffles.  The additive key bias [B, T] is indexed by bh / H,
// keys past T are masked in the kernel (any T, no block divisibility),
// and with `causal` the K tiles past the diagonal are skipped.  A row
// whose keys are all masked gives the JAX kernel's values: m_safe = 0,
// l_safe = max(l, 1e-20), so O = 0 and lse = log(1e-20).  Inputs are
// f32 or bf16 (converted to f32 on the way into shared memory); O is
// written in the input dtype, lse in f32.  Q/K/V/O are addressed by
// their [B, T, H, D] strides, so the split Q/K/V views of a fused QKV
// projection are read in place.  Attention dropout (training) runs in
// the kernel, as in the JAX kernel: the normalizer sums the un-dropped
// probabilities and only the V-weighting is masked, each element's keep
// bit drawn from the uint32 counter hash at its global (head, query,
// key) position (dropout_hash.cuh), so the backward kernel regenerates
// the same mask.  wgmma/TMA come in a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

constexpr int kBM = 64;        // query rows per block
constexpr int kBN = 64;        // keys per K/V tile
constexpr int kThreads = 128;  // 16 row groups x 8 column lanes
constexpr int kLd = 68;        // row stride of the transposed tiles:
                               // 64 + 4 keeps 16-byte alignment

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;  // [B, T] or nullptr
  void* o;
  float* lse;         // [B*H, T]
  int heads, t_len, q_tiles;
  long long q_sb, q_st, q_sh;  // element strides over b, t, h (d is 1)
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_st, o_sh;
  float scale;
  int causal;
  int dropout;          // 1: mask the V-weighting with the keep bits
  uint32_t seed;        // dropout seed
  uint32_t threshold;   // keep when (hash >> 8) < threshold (24-bit)
  float inv_keep;       // 1 / (1 - rate), rounded to f32
};

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(2 * D * kLd + kBN * D + kBN * kLd + kBN) * sizeof(float);
}

template <typename Elt, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd(const Params p) {
  constexpr int kCols = D / 8;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;              // [D][kLd]   Q tile, transposed
  float* ks = qs + D * kLd;      // [D][kLd]   K tile, transposed
  float* vs = ks + D * kLd;      // [kBN][D]   V tile
  float* ps = vs + kBN * D;      // [kBN][kLd] P tile, transposed
  float* bs = ps + kBN * kLd;    // [kBN]      bias, -inf past T

  const int tid = threadIdx.x;
  const int ty = tid >> 3;  // rows ty*4 .. ty*4+3
  const int tx = tid & 7;   // key / output columns tx + 8*j
  const int bh = blockIdx.x / p.q_tiles;
  const int q0 = (blockIdx.x - bh * p.q_tiles) * kBM;
  const int b = bh / p.heads, h = bh - b * p.heads;
  const int t_len = p.t_len;

  const Elt* qg = (const Elt*)p.q + b * p.q_sb + h * p.q_sh;
  const Elt* kg = (const Elt*)p.k + b * p.k_sb + h * p.k_sh;
  const Elt* vg = (const Elt*)p.v + b * p.v_sb + h * p.v_sh;

  for (int i = tid; i < kBM * D; i += kThreads) {
    const int m = i / D, d = i - m * D;
    const int row = q0 + m;
    qs[d * kLd + m] = row < t_len ? load_f(qg + row * p.q_st + d) : 0.f;
  }

  float m_i[4], l_i[4], acc[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_i[r] = -INFINITY;
    l_i[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  int n_tiles = (t_len + kBN - 1) / kBN;
  if (p.causal) n_tiles = min(n_tiles, (q0 + kBM + kBN - 1) / kBN);

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBN;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBN * D; i += kThreads) {
      const int n = i / D, d = i - n * D;
      const int key = k0 + n;
      float kv = 0.f, vv = 0.f;
      if (key < t_len) {
        kv = load_f(kg + key * p.k_st + d);
        vv = load_f(vg + key * p.v_st + d);
      }
      ks[d * kLd + n] = kv;
      vs[n * D + d] = vv;
    }
    if (tid < kBN) {
      const int key = k0 + tid;
      bs[tid] = key < t_len
                    ? (p.bias ? p.bias[(long long)b * t_len + key] : 0.f)
                    : -INFINITY;
    }
    __syncthreads();

    // S = Q K^T for this thread's 4 rows x 8 keys
    float s[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int j = 0; j < 8; ++j) s[r][j] = 0.f;
    }
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qs + d * kLd + ty * 4);
      float kk[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) kk[j] = ks[d * kLd + tx + 8 * j];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[0][j] = fmaf(qv.x, kk[j], s[0][j]);
        s[1][j] = fmaf(qv.y, kk[j], s[1][j]);
        s[2][j] = fmaf(qv.z, kk[j], s[2][j]);
        s[3][j] = fmaf(qv.w, kk[j], s[3][j]);
      }
    }

    // scale + bias + masks, then the online-softmax update per row
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q0 + ty * 4 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tx + 8 * j;
        float x = s[r][j] * p.scale + bs[n];
        if (p.causal && qpos < k0 + n) x = -INFINITY;
        s[r][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_i[r], mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float e = isfinite(s[r][j]) ? expf(s[r][j] - m_safe) : 0.f;
        s[r][j] = e;
        rs += e;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      const float corr = isfinite(m_i[r]) ? expf(m_i[r] - m_safe) : 0.f;
      l_i[r] = l_i[r] * corr + rs;
      m_i[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= corr;
    }
    if (p.dropout) {
      // after the normalizer took the un-dropped values: only the
      // V-weighting sees the mask
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint32_t qpos = (uint32_t)(q0 + ty * 4 + r);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t kpos = (uint32_t)(k0 + tx + 8 * j);
          s[r][j] = dropout_keep(p.seed, (uint32_t)bh, qpos, kpos,
                                 p.threshold)
                        ? s[r][j] * p.inv_keep
                        : 0.f;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float4*>(ps + (tx + 8 * j) * kLd + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // O += P V
#pragma unroll 4
    for (int n = 0; n < kBN; ++n) {
      const float4 pv = *reinterpret_cast<const float4*>(ps + n * kLd + ty * 4);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = vs[n * D + tx + 8 * c];
        acc[0][c] = fmaf(pv.x, vv, acc[0][c]);
        acc[1][c] = fmaf(pv.y, vv, acc[1][c]);
        acc[2][c] = fmaf(pv.z, vv, acc[2][c]);
        acc[3][c] = fmaf(pv.w, vv, acc[3][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qpos = q0 + ty * 4 + r;
    if (qpos >= t_len) continue;
    const float l_safe = fmaxf(l_i[r], 1e-20f);
    Elt* og = (Elt*)p.o + b * p.o_sb + qpos * p.o_st + h * p.o_sh;
#pragma unroll
    for (int c = 0; c < kCols; ++c) store_f(og + tx + 8 * c, acc[r][c] / l_safe);
    if (tx == 0) {
      const float m_fin = isfinite(m_i[r]) ? m_i[r] : 0.f;
      p.lse[(long long)bh * t_len + qpos] = m_fin + logf(l_safe);
    }
  }
}

template <typename Elt, int D>
cudaError_t launch(const Params& p, long long bh, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  // opt in to more than 48 KB of shared memory once per device (not on
  // every launch, so a launch can be captured in a CUDA graph)
  static bool configured[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    e = cudaFuncSetAttribute(flash_fwd<Elt, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    configured[dev] = true;
  }
  const long long blocks = bh * p.q_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_fwd<Elt, D><<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename Elt>
cudaError_t launch_d(const Params& p, long long bh, int d,
                     cudaStream_t stream) {
  switch (d) {
    case 32: return launch<Elt, 32>(p, bh, stream);
    case 64: return launch<Elt, 64>(p, bh, stream);
    case 128: return launch<Elt, 128>(p, bh, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: [B, T, H, D] addressed by `strides` (12 element strides:
// q's b, t, h, then k's, v's and o's; the d stride is 1).  key_bias:
// [B, T] f32 contiguous or null.  lse: [B*H, T] f32 contiguous.
// dtype: 0 = f32, 1 = bf16.  D: 32, 64 or 128.  dropout: 0, or 1 with
// the uint32 seed, the 24-bit keep threshold and 1 / (1 - rate).
// Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const float* key_bias,
                                   void* o, float* lse, int batch, int heads,
                                   int t_len, int d, int dtype, int causal,
                                   float scale, const long long* strides,
                                   int dropout, uint32_t seed,
                                   uint32_t threshold, float inv_keep,
                                   void* stream) {
  if (batch <= 0 || heads <= 0 || t_len <= 0) return 0;
  Params p;
  p.q = q; p.k = k; p.v = v; p.bias = key_bias; p.o = o; p.lse = lse;
  p.heads = heads;
  p.t_len = t_len;
  p.q_tiles = (t_len + kBM - 1) / kBM;
  p.q_sb = strides[0]; p.q_st = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_st = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_st = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_st = strides[10]; p.o_sh = strides[11];
  p.scale = scale;
  p.causal = causal;
  p.dropout = dropout;
  p.seed = seed;
  p.threshold = threshold;
  p.inv_keep = inv_keep;
  const long long bh = (long long)batch * heads;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch_d<float>(p, bh, d, s);
  if (dtype == 1) return (int)launch_d<__nv_bfloat16>(p, bh, d, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
