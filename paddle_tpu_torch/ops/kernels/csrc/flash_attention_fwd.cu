// Flash-attention forward for Hopper (sm_90a):
//   O = dropout(softmax(Q K^T * scale + key_bias [+ causal mask])) V,
//   and the per-row log-sum-exp lse of the un-dropped probabilities,
//   without a [T, T] score matrix in memory.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py:121
// `_flash_fwd_kernel` (launcher `_flash_fwd` :558, pallas_call :585),
// the Pallas TPU kernel behind `flash_attention` / `flash_attention_with_lse`.
//
// Bound on the H100 at BERT-base serving (B=8, H=12, T=512, D=64, f32):
// operations.  The two products take 4*B*H*T^2*D = 6.4 GFLOP; as
// f32-accurate products on the tensor cores each costs three TF32
// products (the split below): 19.3 GFLOP at 495 TFLOP/s, 0.039 ms (on
// the f32 FMA pipe, 67 TFLOP/s: 0.096 ms).  Q, K, V, O, the bias and
// lse are about 50 MB, 15 us at 3.35 TB/s.
//
// Design: a block of 4 warps per (batch*head, 64-row Q tile), each warp
// 16 query rows.  Against the three limits of a scalar-FMA kernel:
//   - products: S = Q K^T and O += P V run on the tensor cores as
//     mma.sync m16n8k8 TF32 with f32 accumulation and the 3xTF32 split
//     of every operand, x = big + small (big = x truncated to TF32,
//     small = x - big), a_big b_big + a_big b_small + a_small b_big,
//     which keeps f32-grade accuracy (one TF32 product alone misses the
//     1e-4 limit).  Operands are split where they are read, not once a
//     block (measured slower on the H100).  The online softmax runs in
//     the accumulator layout: a lane holds 2 rows (g, g + 8) x 2 keys of
//     every 8-key column, a row's max reduces over the 4 lanes of a quad
//     with __shfl_xor, and its sum is kept per lane and reduced once at
//     the end.  P is fed straight from the S accumulators as the A
//     operand of P V (accumulator columns 2t, 2t + 1 as A's k indices t,
//     t + 4, V read with the same permutation), so it never goes through
//     shared memory; each element's dropout keep bit comes from the
//     counter hash at its own (head, query, key), read off its place in
//     the fragment (dropout_hash.cuh), and the normalizer sums the
//     un-dropped probabilities, so the backward kernel regenerates the
//     same mask;
//   - tile loads: Q once, then K, V and the key bias in 32-key tiles
//     through a two-stage cp.async ring (16-byte copies straight into
//     shared memory, rows past T zero-filled), the next tile's copies in
//     flight while the current one is computed; rows are padded by 16
//     bytes, so the fragment reads hit 32 distinct banks; two barriers
//     a tile;
//   - occupancy: at D = 64 a block takes 52.5 KB of shared memory in
//     f32 and 146 registers a thread, so three blocks (12 warps), a
//     number the registers set, share an SM, and BERT-base's 768 blocks
//     run in 1.94 waves; at D = 128, 101.6 KB, two.
//     (Measured on the H100: 64-key tiles at two blocks an SM, four
//     blocks at 128 registers, and a three-stage ring with one barrier
//     a tile ran no faster.)
// The helpers (cp.async, split, fragments, mma) are tf32_mma.cuh's,
// shared with the backward.  Keys past T are masked in the kernel (any
// T), and with `causal` the K tiles past the block's last query are
// skipped.  A row whose keys are all masked gives the JAX kernel's
// values: m_safe = 0, l_safe = max(l, 1e-20), so O = 0 and lse =
// log(1e-20).  O is written in the input dtype, lse in f32.  Q/K/V/O
// are addressed by their [B, T, H, D] strides, so the
// split Q/K/V views of a fused QKV projection are read in place (rows
// on 16 bytes: the wrapper copies a tensor whose rows are not).  No
// atomics: a second launch gives the same O and lse bit for bit.
//
// What holds it back (0.16 ms at BERT-base serving against the 0.039 ms
// bound): every warp splits and reads from shared memory every K and V
// operand it uses, some six instructions an mma, the softmax's
// exponentials and the dropout hash share the issue slots, and mma.sync
// does not reach the tensor cores' wgmma rate.
//
// The bf16 route (`flash_fwd_bf16`) computes what the Pallas kernel
// computes for bf16 inputs (flash_attention.py:130-181): S = Q K^T from
// the bf16 operands with f32 accumulation (mma.sync m16n8k16 bf16, one
// product where the f32 route takes three), the online softmax in f32
// with l summing the unrounded p, the dropped p scaled by 1 / (1 - rate)
// and rounded to bf16 as the A operand of P V (two adjacent n8
// accumulators of S are one k16 A fragment, bf16_mma.cuh), O rounded
// once to bf16 and lse in f32.  The same block shape, 64-key tiles
// through the same two-stage cp.async ring, the Q fragments read once
// into registers.  Bound at BERT-base (B=8, H=12, T=512, D=64):
// operations, 6.44 GFLOP at 989 TFLOP/s bf16, 0.0065 ms; the 25 MB of
// bf16 Q, K, V, O and the f32 lse and bias take 0.0075 ms at 3.35 TB/s,
// so bytes bound it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;  // query rows a block: 16 a warp
constexpr int kTile = 32;           // keys a streamed tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;  // [B, T] or nullptr
  void* o;
  float* lse;         // [B*H, T]
  Strides sq, sk, sv, so;
  int heads, t_len, q_tiles;
  float scale;
  int causal;
  int dropout;          // 1: mask the V-weighting with the keep bits
  uint32_t seed;        // dropout seed
  uint32_t g_offset;    // added to the head index b*H + h in the hash
  uint32_t threshold;   // keep when (hash >> 8) < threshold (24-bit)
  float inv_keep;       // 1 / (1 - rate), rounded to f32
};

template <typename Elt, int D>
constexpr size_t smem_bytes() {
  // the Q tile [kRows][kLd], the K and V rings [2][kTile][kLd], the
  // bias ring [2][kTile] f32
  return (size_t)(kRows + 4 * kTile) * TileShape<Elt, D>::kLd * sizeof(Elt) +
         (size_t)2 * kTile * sizeof(float);
}

template <typename Elt, int D>
__global__ void __launch_bounds__(kThreads, 3) flash_fwd(const Params p) {
  constexpr int kLd = TileShape<Elt, D>::kLd;
  constexpr int kN = kTile / 8;  // 8-key columns of a tile
  constexpr int kD8 = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Elt* qs = (Elt*)smem_raw;        // [kRows][kLd] this block's queries
  Elt* ks = qs + kRows * kLd;      // [2][kTile][kLd] key tiles
  Elt* vs = ks + 2 * kTile * kLd;  // [2][kTile][kLd]
  float* bias_s = (float*)(vs + 2 * kTile * kLd);  // [2][kTile]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x / p.q_tiles;
  const int q0 = (blockIdx.x - bh * p.q_tiles) * kRows;
  const int b = bh / p.heads, h = bh - b * p.heads;
  const int t_len = p.t_len;
  const float* bias_row = p.bias ? p.bias + (long long)b * t_len : nullptr;
  const int qr = warp * 16;  // this warp's queries in the tile

  int n_tiles = (t_len + kTile - 1) / kTile;
  // causal: keys after this query tile are masked for all of it
  if (p.causal) n_tiles = min(n_tiles, (q0 + kRows - 1) / kTile + 1);
  auto issue = [&](int tile, int stage) {
    const int k0 = tile * kTile;
    copy_rows<Elt, D, kTile, kThreads>(ks + stage * kTile * kLd, p.k, p.sk,
                                       b, h, k0, t_len, tid);
    copy_rows<Elt, D, kTile, kThreads>(vs + stage * kTile * kLd, p.v, p.sv,
                                       b, h, k0, t_len, tid);
    if (bias_row)
      copy_vec<kTile, kThreads>(bias_s + stage * kTile, bias_row, k0, t_len,
                                tid);
  };
  copy_rows<Elt, D, kRows, kThreads>(qs, p.q, p.sq, b, h, q0, t_len, tid);
  issue(0, 0);
  cp_commit();

  // this lane's rows g and g + 8: running max, its part of the
  // normalizer, and the 16 x D output accumulator
  float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};
  float o[kD8][4];
#pragma unroll
  for (int i = 0; i < kD8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    if (tile + 1 < n_tiles) issue(tile + 1, stage ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const Elt* kt = ks + stage * kTile * kLd;
    const Elt* vt = vs + stage * kTile * kLd;
    const float* bias_t = bias_s + stage * kTile;
    const int k0 = tile * kTile;
    // S = Q K^T for 16 queries x kTile keys
    float s[kN][4];
#pragma unroll
    for (int n = 0; n < kN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kD8; ++kk) {
      const FragA qa = tile_a(qs, kLd, qr, kk * 8, g, t4);
#pragma unroll
      for (int n = 0; n < kN; ++n)
        mma3(s[n], qa, tile_bt(kt, kLd, n * 8, kk * 8, g, t4));
    }
    // scale, bias and masks; the rows' max over the quad
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kl = n * 8 + 2 * t4 + (e & 1);
        const int key = k0 + kl;
        const int qpos = q0 + qr + g + 8 * r;
        float x = s[n][e] * p.scale + (bias_row ? bias_t[kl] : 0.f);
        if (key >= t_len || (p.causal && qpos < key)) x = -INFINITY;
        s[n][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float m_safe[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_i[r], mx[r]);
      m_safe[r] = isfinite(m_new) ? m_new : 0.f;
      const float corr =
          isfinite(m_i[r]) ? __expf(m_i[r] - m_safe[r]) : 0.f;
      m_i[r] = m_new;
      l_i[r] *= corr;
#pragma unroll
      for (int dt = 0; dt < kD8; ++dt) {
        o[dt][2 * r] *= corr;
        o[dt][2 * r + 1] *= corr;
      }
    }
    // P: the normalizer sums the un-dropped values, only the
    // V-weighting sees the mask
#pragma unroll
    for (int n = 0; n < kN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float pr =
            isfinite(s[n][e]) ? __expf(s[n][e] - m_safe[r]) : 0.f;
        l_i[r] += pr;
        float pu = pr;
        if (p.dropout) {
          const int key = k0 + n * 8 + 2 * t4 + (e & 1);
          const int qpos = q0 + qr + g + 8 * r;
          pu = dropout_keep(p.seed, (uint32_t)bh + p.g_offset,
                            (uint32_t)qpos,
                            (uint32_t)key, p.threshold)
                   ? pr * p.inv_keep
                   : 0.f;
        }
        s[n][e] = pu;
      }
    }
    // O += P V over the tile's keys
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const FragA pa = acc_a(s[n]);
#pragma unroll
      for (int dt = 0; dt < kD8; ++dt)
        mma3(o[dt], pa, tile_b_perm(vt, kLd, n * 8, dt * 8, g, t4));
    }
    __syncthreads();  // this stage is read before the next issue fills it
  }
  cp_wait<0>();

  // the normalizer of a row: the 4 lanes of a quad hold disjoint keys
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + qr + g + 8 * r;
    if (row >= t_len) continue;
    const float l_safe = fmaxf(l_i[r], 1e-20f);
    Elt* og = (Elt*)p.o + row_off(p.so, b, row, h);
#pragma unroll
    for (int dt = 0; dt < kD8; ++dt)
      store2(og + dt * 8 + 2 * t4, o[dt][2 * r] / l_safe,
             o[dt][2 * r + 1] / l_safe);
    if (t4 == 0) {
      const float m_fin = isfinite(m_i[r]) ? m_i[r] : 0.f;
      p.lse[(long long)bh * t_len + row] = m_fin + logf(l_safe);
    }
  }
}

// ------------------------------------------------------- bf16 route

constexpr int kTileB = 64;  // keys a streamed tile of the bf16 route

template <int D>
constexpr size_t smem_bytes_bf16() {
  // the Q tile [kRows][kLd], the K and V rings [2][kTileB][kLd], the
  // bias ring [2][kTileB] f32
  return (size_t)(kRows + 4 * kTileB) *
             TileShape<__nv_bfloat16, D>::kLd * sizeof(__nv_bfloat16) +
         (size_t)2 * kTileB * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_bf16(const Params p) {
  using Elt = __nv_bfloat16;
  constexpr int kLd = TileShape<Elt, D>::kLd;
  constexpr int kN = kTileB / 8;  // 8-key columns of a tile
  constexpr int kD8 = D / 8;
  constexpr int kD16 = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Elt* qs = (Elt*)smem_raw;         // [kRows][kLd] this block's queries
  Elt* ks = qs + kRows * kLd;       // [2][kTileB][kLd] key tiles
  Elt* vs = ks + 2 * kTileB * kLd;  // [2][kTileB][kLd]
  float* bias_s = (float*)(vs + 2 * kTileB * kLd);  // [2][kTileB]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x / p.q_tiles;
  const int q0 = (blockIdx.x - bh * p.q_tiles) * kRows;
  const int b = bh / p.heads, h = bh - b * p.heads;
  const int t_len = p.t_len;
  const float* bias_row = p.bias ? p.bias + (long long)b * t_len : nullptr;
  const int qr = warp * 16;  // this warp's queries in the tile

  int n_tiles = (t_len + kTileB - 1) / kTileB;
  if (p.causal) n_tiles = min(n_tiles, (q0 + kRows - 1) / kTileB + 1);
  auto issue = [&](int tile, int stage) {
    const int k0 = tile * kTileB;
    copy_rows<Elt, D, kTileB, kThreads>(ks + stage * kTileB * kLd, p.k,
                                        p.sk, b, h, k0, t_len, tid);
    copy_rows<Elt, D, kTileB, kThreads>(vs + stage * kTileB * kLd, p.v,
                                        p.sv, b, h, k0, t_len, tid);
    if (bias_row)
      copy_vec<kTileB, kThreads>(bias_s + stage * kTileB, bias_row, k0,
                                 t_len, tid);
  };
  copy_rows<Elt, D, kRows, kThreads>(qs, p.q, p.sq, b, h, q0, t_len, tid);
  issue(0, 0);
  cp_commit();

  float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};
  float o[kD8][4];
#pragma unroll
  for (int i = 0; i < kD8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  }
  FragA16 qa[kD16];  // this warp's 16 queries, read once

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    if (tile + 1 < n_tiles) issue(tile + 1, stage ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    if (tile == 0) {
#pragma unroll
      for (int kk = 0; kk < kD16; ++kk)
        qa[kk] = tile_a16(qs, kLd, qr, kk * 16, g, t4);
    }
    const Elt* kt = ks + stage * kTileB * kLd;
    const Elt* vt = vs + stage * kTileB * kLd;
    const float* bias_t = bias_s + stage * kTileB;
    const int k0 = tile * kTileB;
    // S = Q K^T for 16 queries x kTileB keys, one bf16 product
    float s[kN][4];
#pragma unroll
    for (int n = 0; n < kN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kD16; ++kk) {
#pragma unroll
      for (int n = 0; n < kN; ++n)
        mma_bf16(s[n], qa[kk], tile_bt16(kt, kLd, n * 8, kk * 16, g, t4));
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kl = n * 8 + 2 * t4 + (e & 1);
        const int key = k0 + kl;
        const int qpos = q0 + qr + g + 8 * r;
        float x = s[n][e] * p.scale + (bias_row ? bias_t[kl] : 0.f);
        if (key >= t_len || (p.causal && qpos < key)) x = -INFINITY;
        s[n][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float m_safe[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_i[r], mx[r]);
      m_safe[r] = isfinite(m_new) ? m_new : 0.f;
      const float corr =
          isfinite(m_i[r]) ? __expf(m_i[r] - m_safe[r]) : 0.f;
      m_i[r] = m_new;
      l_i[r] *= corr;
#pragma unroll
      for (int dt = 0; dt < kD8; ++dt) {
        o[dt][2 * r] *= corr;
        o[dt][2 * r + 1] *= corr;
      }
    }
    // P in f32: l sums the unrounded values; the dropped, rescaled
    // values are rounded to bf16 where they become A fragments
#pragma unroll
    for (int n = 0; n < kN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float pr =
            isfinite(s[n][e]) ? __expf(s[n][e] - m_safe[r]) : 0.f;
        l_i[r] += pr;
        float pu = pr;
        if (p.dropout) {
          const int key = k0 + n * 8 + 2 * t4 + (e & 1);
          const int qpos = q0 + qr + g + 8 * r;
          pu = dropout_keep(p.seed, (uint32_t)bh + p.g_offset,
                            (uint32_t)qpos, (uint32_t)key, p.threshold)
                   ? pr * p.inv_keep
                   : 0.f;
        }
        s[n][e] = pu;
      }
    }
    // O += P V over the tile's keys, 16 keys a product
#pragma unroll
    for (int j = 0; j < kN / 2; ++j) {
      const FragA16 pa = acc_a16(s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int dt = 0; dt < kD8; ++dt)
        mma_bf16(o[dt], pa, tile_b16(vt, kLd, j * 16, dt * 8, g, t4));
    }
    __syncthreads();  // this stage is read before the next issue fills it
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + qr + g + 8 * r;
    if (row >= t_len) continue;
    const float l_safe = fmaxf(l_i[r], 1e-20f);
    Elt* og = (Elt*)p.o + row_off(p.so, b, row, h);
#pragma unroll
    for (int dt = 0; dt < kD8; ++dt)
      store2(og + dt * 8 + 2 * t4, o[dt][2 * r] / l_safe,
             o[dt][2 * r + 1] / l_safe);
    if (t4 == 0) {
      const float m_fin = isfinite(m_i[r]) ? m_i[r] : 0.f;
      p.lse[(long long)bh * t_len + row] = m_fin + logf(l_safe);
    }
  }
}

template <int D>
cudaError_t launch_bf16(const Params& p, long long bh, cudaStream_t stream) {
  static bool configured[64] = {};
  const size_t smem = smem_bytes_bf16<D>();
  cudaError_t e = configure(flash_fwd_bf16<D>, smem, configured);
  if (e != cudaSuccess) return e;
  const long long blocks = bh * p.q_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_fwd_bf16<D><<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename Elt, int D>
cudaError_t launch(const Params& p, long long bh, cudaStream_t stream) {
  static bool configured[64] = {};
  const size_t smem = smem_bytes<Elt, D>();
  cudaError_t e = configure(flash_fwd<Elt, D>, smem, configured);
  if (e != cudaSuccess) return e;
  const long long blocks = bh * p.q_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_fwd<Elt, D><<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_d(const Params& p, long long bh, int d, int dtype,
                     cudaStream_t stream) {
  if (dtype == 0) {
    switch (d) {
      case 32: return launch<float, 32>(p, bh, stream);
      case 64: return launch<float, 64>(p, bh, stream);
      case 128: return launch<float, 128>(p, bh, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    switch (d) {
      case 32: return launch_bf16<32>(p, bh, stream);
      case 64: return launch_bf16<64>(p, bh, stream);
      case 128: return launch_bf16<128>(p, bh, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, o: [B, T, H, D] addressed by `strides` (12 element strides:
// q's b, t, h, then k's, v's and o's; the d stride is 1); q, k and v
// start on 16 bytes and their rows on 16-byte multiples.  key_bias:
// [B, T] f32 contiguous or null.  lse: [B*H, T] f32 contiguous.
// dtype: 0 = f32 (3xTF32 products), 1 = bf16 (bf16 products, the
// Pallas kernel's rounding points).  D: 32, 64 or 128.  dropout: 0, or
// 1 with the uint32 seed, the 24-bit keep threshold and 1 / (1 - rate);
// g_offset shifts the hash's head index b*H + h (a data-parallel rank's
// rows of the global batch start at rank * B * H).
// Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const float* key_bias,
                                   void* o, float* lse, int batch, int heads,
                                   int t_len, int d, int dtype, int causal,
                                   float scale, const long long* strides,
                                   int dropout, uint32_t seed,
                                   uint32_t g_offset, uint32_t threshold,
                                   float inv_keep, void* stream) {
  if (batch <= 0 || heads <= 0 || t_len <= 0) return 0;
  Params p;
  p.q = q; p.k = k; p.v = v; p.bias = key_bias; p.o = o; p.lse = lse;
  p.sq = strides_at(strides, 0);
  p.sk = strides_at(strides, 1);
  p.sv = strides_at(strides, 2);
  p.so = strides_at(strides, 3);
  p.heads = heads;
  p.t_len = t_len;
  p.q_tiles = (t_len + kRows - 1) / kRows;
  p.scale = scale;
  p.causal = causal;
  p.dropout = dropout;
  p.seed = seed;
  p.g_offset = g_offset;
  p.threshold = threshold;
  p.inv_keep = inv_keep;
  const int elt = dtype == 0 ? 4 : 2;
  if (!copy_aligned(q, p.sq, elt) || !copy_aligned(k, p.sk, elt) ||
      !copy_aligned(v, p.sv, elt))
    return (int)cudaErrorMisalignedAddress;
  const long long bh = (long long)batch * heads;
  return (int)launch_d(p, bh, d, dtype, (cudaStream_t)stream);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
