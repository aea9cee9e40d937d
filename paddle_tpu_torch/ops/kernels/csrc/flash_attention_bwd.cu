// Flash-attention backward for Hopper (sm_90a): dQ, dK, dV and the
// per-(batch*head, key) bias cotangent of
//   O = dropout(softmax(Q K^T * scale + key_bias [+ causal mask])) V,
// from Q, K, V, O, the forward's lse and dO, without a [T, T] matrix in
// memory.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py:361
// `_flash_bwd_fused_kernel` (launcher `_flash_bwd_fused` :484,
// pallas_call :519), the backward the JAX package runs at BERT's shapes,
// and computes the same function as its two-pass fallback
// `_flash_bwd_dq_kernel` (:200) + `_flash_bwd_dkv_kernel` (:273)
// (`_flash_bwd` :602, pallas_calls :657, :705), whose schedule it takes.
//
// Bound on the H100 at BERT-base pretraining (B=8, H=12, T=512, D=64,
// f32): operations.  The gradient needs four T x T x D products per
// head (S, dP, dV, dK for dK/dV; dQ on top: five, 10*B*H*T^2*D = 16.1
// GFLOP in all with the recomputed S and dP of the dQ pass, 8 with the
// fused one-pass schedule), against some 90 MB of tensors; the bound
// counts the 4 products a one-pass schedule needs.
//
// Design.  The TPU kernel walks one head per grid step and carries dQ
// in VMEM; on Hopper that gives 96 blocks for 132 SMs, and dQ summed
// across key tiles in parallel would need float atomics.  So the work
// is split as in the JAX package's two-pass scheme, with no atomics:
//   1. delta = rowsum(dO * O) - g_lse (one warp per row);
//   2. dK/dV: one block of 128 threads per (batch*head, 64-key tile)
//      streams 64-query tiles of Q, dO, lse and delta through shared
//      memory; for its 4 keys x 8 queries a thread recomputes
//      p = exp(s - lse), takes dP = dO V^T, applies the dropout mask to
//      both (the same hash as the forward), ds = p * (dP - delta), and
//      accumulates dV += p_dropped^T dO, dK += ds^T Q and the bias
//      cotangent (the column sum of ds) in f32 registers;
//   3. dQ: one block per (batch*head, 64-query tile) streams 64-key tiles
//      of K, V and the bias and accumulates dQ += ds K.
// Scores and products use f32 FMAs (no TF32).  Q/K/V/O/dO and the
// outputs are addressed by their [B, T, H, D] strides, so the split
// Q/K/V views of the fused projection need no copy; ragged T is masked
// in the kernels (keys past T score -inf, rows past T are zero); rows
// whose keys are all masked follow the JAX rule through the forward's
// lse (p = 0, so their gradients are 0).  The bias cotangent comes out
// per (batch*head, key); the wrapper sums it over heads, as the JAX
// launcher does.  wgmma/TMA come in a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

constexpr int kTile = 64;      // queries per Q tile, keys per K tile
constexpr int kThreads = 128;  // 16 row groups x 8 column lanes
constexpr int kLd = 68;        // row stride of the tiles read as float4

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Strides {
  long long b, t, h;  // element strides over b, t, h (d is 1)
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* bias;   // [B, T] or nullptr
  const float* lse;    // [B*H, T]
  const float* glse;   // [B*H, T] lse cotangent or nullptr
  float* delta;        // [B*H, T] scratch
  void* dq;
  void* dk;
  void* dv;
  float* dbias;        // [B*H, T] or nullptr
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int heads, t_len, tiles;
  float scale;
  int causal;
  int dropout;
  uint32_t seed;
  uint32_t threshold;
  float inv_keep;
};

__device__ __forceinline__ long long row_off(const Strides& s, int b,
                                             int t, int h) {
  return (long long)b * s.b + (long long)t * s.t + (long long)h * s.h;
}

// 1. delta[bh, t] = sum_d dO * O - g_lse, one warp per (bh, t) row
template <typename Elt>
__global__ void flash_bwd_delta(const Params p, int d, long long rows) {
  const long long row =
      (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int bh = (int)(row / p.t_len), t = (int)(row - (long long)bh * p.t_len);
  const int b = bh / p.heads, h = bh - b * p.heads;
  const Elt* og = (const Elt*)p.o + row_off(p.so, b, t, h);
  const Elt* dg = (const Elt*)p.dout + row_off(p.sdo, b, t, h);
  float acc = 0.f;
  for (int i = lane; i < d; i += 32) acc += load_f(dg + i) * load_f(og + i);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) p.delta[row] = acc - (p.glse ? p.glse[row] : 0.f);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // K^T, V^T [D][kLd]; Q, dO [64][D+1]; P^T, dS^T [64][kLd]; lse,
  // delta, bias [64]
  return (size_t)(2 * D * kLd + 2 * kTile * (D + 1) + 2 * kTile * kLd +
                  3 * kTile) * sizeof(float);
}

// 2. dK, dV (and the bias cotangent) for one (batch*head, key tile)
template <typename Elt, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv(const Params p) {
  constexpr int kCols = D / 8;
  constexpr int kLdr = D + 1;
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                  // [D][kLd]   K tile, transposed
  float* vt = kt + D * kLd;          // [D][kLd]   V tile, transposed
  float* qr = vt + D * kLd;          // [64][D+1]  Q tile
  float* dor = qr + kTile * kLdr;    // [64][D+1]  dO tile
  float* pt = dor + kTile * kLdr;    // [64 q][kLd] dropped P, by query
  float* dst = pt + kTile * kLd;     // [64 q][kLd] dS, by query
  float* lse_s = dst + kTile * kLd;  // [64]
  float* delta_s = lse_s + kTile;    // [64]
  float* bias_s = delta_s + kTile;   // [64] per key, -inf past T

  const int tid = threadIdx.x;
  const int ty = tid >> 3;  // keys ty*4 .. ty*4+3
  const int tx = tid & 7;   // queries / output columns tx + 8*j
  const int bh = blockIdx.x / p.tiles;
  const int k0 = (blockIdx.x - bh * p.tiles) * kTile;
  const int b = bh / p.heads, h = bh - b * p.heads;
  const int t_len = p.t_len;

  for (int i = tid; i < kTile * D; i += kThreads) {
    const int n = i / D, d = i - n * D;
    const int key = k0 + n;
    float kv = 0.f, vv = 0.f;
    if (key < t_len) {
      kv = load_f((const Elt*)p.k + row_off(p.sk, b, key, h) + d);
      vv = load_f((const Elt*)p.v + row_off(p.sv, b, key, h) + d);
    }
    kt[d * kLd + n] = kv;
    vt[d * kLd + n] = vv;
  }
  if (tid < kTile) {
    const int key = k0 + tid;
    bias_s[tid] = key < t_len
                      ? (p.bias ? p.bias[(long long)b * t_len + key] : 0.f)
                      : -INFINITY;
  }

  float dk[4][kCols], dv[4][kCols], db[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    db[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk[r][c] = dv[r][c] = 0.f;
  }

  const int n_tiles = (t_len + kTile - 1) / kTile;
  // causal: queries before this key tile see none of its keys
  const int first = p.causal ? k0 / kTile : 0;
  for (int tile = first; tile < n_tiles; ++tile) {
    const int q0 = tile * kTile;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kTile * D; i += kThreads) {
      const int m = i / D, d = i - m * D;
      const int row = q0 + m;
      float qv = 0.f, dov = 0.f;
      if (row < t_len) {
        qv = load_f((const Elt*)p.q + row_off(p.sq, b, row, h) + d);
        dov = load_f((const Elt*)p.dout + row_off(p.sdo, b, row, h) + d);
      }
      qr[m * kLdr + d] = qv;
      dor[m * kLdr + d] = dov;
    }
    if (tid < kTile) {
      const int row = q0 + tid;
      const long long off = (long long)bh * t_len + row;
      // rows past T: lse = +inf makes their p exactly 0
      lse_s[tid] = row < t_len ? p.lse[off] : INFINITY;
      delta_s[tid] = row < t_len ? p.delta[off] : 0.f;
    }
    __syncthreads();

    // S^T and dP^T for this thread's 4 keys x 8 queries
    float s[4][8], dp[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int j = 0; j < 8; ++j) s[r][j] = dp[r][j] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 kv = *reinterpret_cast<const float4*>(kt + d * kLd + ty * 4);
      const float4 vv = *reinterpret_cast<const float4*>(vt + d * kLd + ty * 4);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float qv = qr[(tx + 8 * j) * kLdr + d];
        const float dov = dor[(tx + 8 * j) * kLdr + d];
        s[0][j] = fmaf(kv.x, qv, s[0][j]);
        s[1][j] = fmaf(kv.y, qv, s[1][j]);
        s[2][j] = fmaf(kv.z, qv, s[2][j]);
        s[3][j] = fmaf(kv.w, qv, s[3][j]);
        dp[0][j] = fmaf(vv.x, dov, dp[0][j]);
        dp[1][j] = fmaf(vv.y, dov, dp[1][j]);
        dp[2][j] = fmaf(vv.z, dov, dp[2][j]);
        dp[3][j] = fmaf(vv.w, dov, dp[3][j]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int key = k0 + ty * 4 + r;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int m = tx + 8 * j;
        const int qpos = q0 + m;
        float x = s[r][j] * p.scale + bias_s[ty * 4 + r];
        if (p.causal && qpos < key) x = -INFINITY;
        const float pr = isfinite(x) ? expf(x - lse_s[m]) : 0.f;
        float pu = pr, dpu = dp[r][j];
        if (p.dropout) {
          const bool keep = dropout_keep(p.seed, (uint32_t)bh, (uint32_t)qpos,
                                         (uint32_t)key, p.threshold);
          pu = keep ? pr * p.inv_keep : 0.f;
          dpu = keep ? dpu * p.inv_keep : 0.f;
        }
        const float ds = pr * (dpu - delta_s[m]);
        db[r] += ds;
        s[r][j] = pu;
        dp[r][j] = ds;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int m = tx + 8 * j;
      *reinterpret_cast<float4*>(pt + m * kLd + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      *reinterpret_cast<float4*>(dst + m * kLd + ty * 4) =
          make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
    }
    __syncthreads();

    // dV += P_dropped^T dO, dK += dS^T Q over the 64 queries
#pragma unroll 2
    for (int m = 0; m < kTile; ++m) {
      const float4 pv = *reinterpret_cast<const float4*>(pt + m * kLd + ty * 4);
      const float4 sv = *reinterpret_cast<const float4*>(dst + m * kLd + ty * 4);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float dov = dor[m * kLdr + tx + 8 * c];
        const float qv = qr[m * kLdr + tx + 8 * c];
        dv[0][c] = fmaf(pv.x, dov, dv[0][c]);
        dv[1][c] = fmaf(pv.y, dov, dv[1][c]);
        dv[2][c] = fmaf(pv.z, dov, dv[2][c]);
        dv[3][c] = fmaf(pv.w, dov, dv[3][c]);
        dk[0][c] = fmaf(sv.x, qv, dk[0][c]);
        dk[1][c] = fmaf(sv.y, qv, dk[1][c]);
        dk[2][c] = fmaf(sv.z, qv, dk[2][c]);
        dk[3][c] = fmaf(sv.w, qv, dk[3][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    // the bias cotangent of a key sums ds over all queries: the 8 lanes
    // of a row group hold disjoint query sets
    float x = db[r];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    x += __shfl_xor_sync(0xffffffffu, x, 4);
    const int key = k0 + ty * 4 + r;
    if (key >= t_len) continue;
    Elt* dkg = (Elt*)p.dk + row_off(p.sdk, b, key, h);
    Elt* dvg = (Elt*)p.dv + row_off(p.sdv, b, key, h);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      store_f(dkg + tx + 8 * c, dk[r][c] * p.scale);
      store_f(dvg + tx + 8 * c, dv[r][c]);
    }
    if (p.dbias && tx == 0) p.dbias[(long long)bh * t_len + key] = x;
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // Q^T, dO^T [D][kLd]; K, V [64][D+1]; dS [64 keys][kLd]; bias [64]
  return (size_t)(2 * D * kLd + 2 * kTile * (D + 1) + kTile * kLd + kTile) *
         sizeof(float);
}

// 3. dQ for one (batch*head, query tile)
template <typename Elt, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq(const Params p) {
  constexpr int kCols = D / 8;
  constexpr int kLdr = D + 1;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                 // [D][kLd]   Q tile, transposed
  float* dot = qt + D * kLd;        // [D][kLd]   dO tile, transposed
  float* kr = dot + D * kLd;        // [64][D+1]  K tile
  float* vr = kr + kTile * kLdr;    // [64][D+1]  V tile
  float* dst = vr + kTile * kLdr;   // [64 k][kLd] dS, by key
  float* bias_s = dst + kTile * kLd;  // [64] per key, -inf past T

  const int tid = threadIdx.x;
  const int ty = tid >> 3;  // queries ty*4 .. ty*4+3
  const int tx = tid & 7;   // keys / output columns tx + 8*j
  const int bh = blockIdx.x / p.tiles;
  const int q0 = (blockIdx.x - bh * p.tiles) * kTile;
  const int b = bh / p.heads, h = bh - b * p.heads;
  const int t_len = p.t_len;

  for (int i = tid; i < kTile * D; i += kThreads) {
    const int m = i / D, d = i - m * D;
    const int row = q0 + m;
    float qv = 0.f, dov = 0.f;
    if (row < t_len) {
      qv = load_f((const Elt*)p.q + row_off(p.sq, b, row, h) + d);
      dov = load_f((const Elt*)p.dout + row_off(p.sdo, b, row, h) + d);
    }
    qt[d * kLd + m] = qv;
    dot[d * kLd + m] = dov;
  }
  float lse[4], delta[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty * 4 + r;
    const long long off = (long long)bh * t_len + row;
    lse[r] = row < t_len ? p.lse[off] : INFINITY;
    delta[r] = row < t_len ? p.delta[off] : 0.f;
  }

  float dq[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) dq[r][c] = 0.f;
  }

  int n_tiles = (t_len + kTile - 1) / kTile;
  if (p.causal) n_tiles = min(n_tiles, (q0 + 2 * kTile - 1) / kTile);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kTile;
    __syncthreads();
    for (int i = tid; i < kTile * D; i += kThreads) {
      const int n = i / D, d = i - n * D;
      const int key = k0 + n;
      float kv = 0.f, vv = 0.f;
      if (key < t_len) {
        kv = load_f((const Elt*)p.k + row_off(p.sk, b, key, h) + d);
        vv = load_f((const Elt*)p.v + row_off(p.sv, b, key, h) + d);
      }
      kr[n * kLdr + d] = kv;
      vr[n * kLdr + d] = vv;
    }
    if (tid < kTile) {
      const int key = k0 + tid;
      bias_s[tid] = key < t_len
                        ? (p.bias ? p.bias[(long long)b * t_len + key] : 0.f)
                        : -INFINITY;
    }
    __syncthreads();

    float s[4][8], dp[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int j = 0; j < 8; ++j) s[r][j] = dp[r][j] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qt + d * kLd + ty * 4);
      const float4 dov = *reinterpret_cast<const float4*>(dot + d * kLd + ty * 4);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float kv = kr[(tx + 8 * j) * kLdr + d];
        const float vv = vr[(tx + 8 * j) * kLdr + d];
        s[0][j] = fmaf(qv.x, kv, s[0][j]);
        s[1][j] = fmaf(qv.y, kv, s[1][j]);
        s[2][j] = fmaf(qv.z, kv, s[2][j]);
        s[3][j] = fmaf(qv.w, kv, s[3][j]);
        dp[0][j] = fmaf(dov.x, vv, dp[0][j]);
        dp[1][j] = fmaf(dov.y, vv, dp[1][j]);
        dp[2][j] = fmaf(dov.z, vv, dp[2][j]);
        dp[3][j] = fmaf(dov.w, vv, dp[3][j]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q0 + ty * 4 + r;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tx + 8 * j;
        const int key = k0 + n;
        float x = s[r][j] * p.scale + bias_s[n];
        if (p.causal && qpos < key) x = -INFINITY;
        const float pr = isfinite(x) ? expf(x - lse[r]) : 0.f;
        float dpu = dp[r][j];
        if (p.dropout)
          dpu = dropout_keep(p.seed, (uint32_t)bh, (uint32_t)qpos,
                             (uint32_t)key, p.threshold)
                    ? dpu * p.inv_keep
                    : 0.f;
        s[r][j] = pr * (dpu - delta[r]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float4*>(dst + (tx + 8 * j) * kLd + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // dQ += dS K over the 64 keys
#pragma unroll 4
    for (int n = 0; n < kTile; ++n) {
      const float4 sv = *reinterpret_cast<const float4*>(dst + n * kLd + ty * 4);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float kv = kr[n * kLdr + tx + 8 * c];
        dq[0][c] = fmaf(sv.x, kv, dq[0][c]);
        dq[1][c] = fmaf(sv.y, kv, dq[1][c]);
        dq[2][c] = fmaf(sv.z, kv, dq[2][c]);
        dq[3][c] = fmaf(sv.w, kv, dq[3][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty * 4 + r;
    if (row >= t_len) continue;
    Elt* dqg = (Elt*)p.dq + row_off(p.sdq, b, row, h);
#pragma unroll
    for (int c = 0; c < kCols; ++c) store_f(dqg + tx + 8 * c, dq[r][c] * p.scale);
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

template <typename Elt, int D>
cudaError_t launch(const Params& p, long long bh, cudaStream_t stream) {
  static bool dkv_configured[64] = {};
  static bool dq_configured[64] = {};
  const size_t dkv_smem = dkv_smem_bytes<D>();
  const size_t dq_smem = dq_smem_bytes<D>();
  cudaError_t e = configure(flash_bwd_dkv<Elt, D>, dkv_smem, dkv_configured);
  if (e != cudaSuccess) return e;
  e = configure(flash_bwd_dq<Elt, D>, dq_smem, dq_configured);
  if (e != cudaSuccess) return e;
  const long long rows = bh * p.t_len;
  const long long blocks = bh * p.tiles;
  if (blocks > 0x7fffffffLL || (rows + 7) / 8 > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  flash_bwd_delta<Elt><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      p, D, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkv<Elt, D><<<(unsigned)blocks, kThreads, dkv_smem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dq<Elt, D><<<(unsigned)blocks, kThreads, dq_smem, stream>>>(p);
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

Strides strides_at(const long long* s, int i) {
  Strides r;
  r.b = s[3 * i];
  r.t = s[3 * i + 1];
  r.h = s[3 * i + 2];
  return r;
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: [B, T, H, D] addressed by `strides` (24
// element strides: b, t, h of each in that order; the d stride is 1).
// key_bias: [B, T] f32 contiguous or null.  lse, glse (or null), delta
// (scratch), dbias (or null): [B*H, T] f32 contiguous.  dtype: 0 = f32,
// 1 = bf16.  D: 32, 64 or 128.  dropout: 0, or 1 with the forward's
// seed, 24-bit keep threshold and 1 / (1 - rate).  Launches the delta,
// dK/dV and dQ kernels in that order on `stream`; returns the first
// CUDA error (0 on success).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* key_bias, const float* lse,
    const float* glse, float* delta, void* dq, void* dk, void* dv,
    float* dbias, int batch, int heads, int t_len, int d, int dtype,
    int causal, float scale, const long long* strides, int dropout,
    uint32_t seed, uint32_t threshold, float inv_keep, void* stream) {
  if (batch <= 0 || heads <= 0 || t_len <= 0) return 0;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.bias = key_bias; p.lse = lse; p.glse = glse; p.delta = delta;
  p.dq = dq; p.dk = dk; p.dv = dv; p.dbias = dbias;
  p.sq = strides_at(strides, 0);
  p.sk = strides_at(strides, 1);
  p.sv = strides_at(strides, 2);
  p.so = strides_at(strides, 3);
  p.sdo = strides_at(strides, 4);
  p.sdq = strides_at(strides, 5);
  p.sdk = strides_at(strides, 6);
  p.sdv = strides_at(strides, 7);
  p.heads = heads;
  p.t_len = t_len;
  p.tiles = (t_len + kTile - 1) / kTile;
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
