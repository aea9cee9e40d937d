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
// f32): operations.  The gradient needs five T x T x D products per
// head (S, dP, dV, dK, dQ): 10*B*H*T^2*D = 16.1 GFLOP, against some 90
// MB of tensors (the two-pass schedule below computes S and dP twice,
// seven products).  f32-accurate products on the tensor cores cost
// three TF32 products each: 48 GFLOP at 495 TFLOP/s, 0.098 ms; on the
// f32 FMA pipe (67 TFLOP/s) 0.24 ms.
//
// Design.  The TPU kernel walks one head per grid step and carries dQ
// in VMEM; on Hopper that gives 96 blocks for 132 SMs, and dQ summed
// across key tiles in parallel would need float atomics.  So the work
// is split as in the JAX package's two-pass scheme, with no atomics
// (the result is the same bit for bit from launch to launch):
//   1. delta = rowsum(dO * O) - g_lse (one warp per row);
//   2. dK/dV: a block of 4 warps per (batch*head, 64-key tile), each
//      warp 16 keys, streams tiles of Q, dO, lse and delta;
//   3. dQ: a block of 4 warps per (batch*head, 64-query tile), each
//      warp 16 queries, streams tiles of K, V and the bias.
// Products run on the tensor cores: mma.sync m16n8k8 TF32 with f32
// accumulation and the 3xTF32 split of every operand, x = big + small
// with big = tf32(x) and small = x - big, each product a_big b_big +
// a_big b_small + a_small b_big, which keeps f32-grade accuracy (one
// TF32 product alone loses ~3 decimal digits).  S^T and dP^T (dK/dV
// pass) or S and dP (dQ pass) are computed into mma accumulators,
// turned into P / dS element by element in registers (each element's
// (query, key) read off its place in the fragment, so the dropout keep
// bit is the forward's), and fed straight back as the A operand of the
// next product: an accumulator's columns 2t, 2t+1 are taken as the A
// fragment's k indices t, t+4, and the B operand is read with the same
// permutation, so P and dS never go through shared memory.  The
// streamed tiles, 32 rows each, arrive through a two-stage cp.async
// ring (16-byte copies straight into shared memory; rows past T
// zero-filled), the next tile's copies in flight while the current one
// is computed.  Tile rows are padded by 16 bytes, so the fragment reads
// (row g, column t and row 2t, column g patterns) hit 32 distinct
// banks.  At D = 64 a block takes 70 KB of shared memory and 168
// registers a thread, so three blocks (12 warps) share an SM; at D =
// 128, 133 KB, one.  (Measured on the H100: 64-row streamed tiles, two
// blocks an SM, ran slower.)  Q/K/V/dO and
// the outputs are addressed by their [B, T, H, D] strides, so the
// split Q/K/V views of the fused projection need no copy; ragged T is
// masked in the kernels (keys or queries past T give p = 0); rows whose
// keys are all masked follow the JAX rule through the forward's lse
// (p = 0, so their gradients are 0).  The bias cotangent comes out per
// (batch*head, key), summed over queries in a fixed order; the wrapper
// sums it over heads, as the JAX launcher does.
//
// The cp.async, split, fragment and mma helpers are tf32_mma.cuh's,
// shared with the forward kernel.
//
// What holds it back (0.51 ms at BERT-base against a 0.098 ms bound):
// every operand is split and read from shared memory by each warp that
// uses it, some six instructions an mma, and mma.sync does not reach
// the tensor cores' wgmma rate.
//
// The bf16 route (`flash_bwd_dkv_bf16`, `flash_bwd_dq_bf16`, after the
// same delta pass and with the same two-pass schedule) computes what the
// Pallas kernel computes for bf16 inputs (flash_attention.py:410-453): S
// and dP = dO V^T from the bf16 operands with f32 accumulation, P and dS
// in f32, dV += P_drop^T dO with P_drop rounded to bf16, dK += dS^T Q
// and dQ += dS K with dS rounded to bf16, the bias cotangent summed in
// f32 in a fixed order, and dQ, dK, dV rounded once to bf16.  Bound at
// BERT-base (B=8, H=12, T=512, D=64): operations, 16.1 GFLOP at 989
// TFLOP/s bf16, 0.0163 ms; the 50 MB of bf16 Q, K, V, O, dO, dQ, dK, dV
// take 0.015 ms at 3.35 TB/s.  Design, for Hopper (hopper_wgmma.cuh),
// as the forward's bf16 route: a block of one producer warp and NWG
// consumer warpgroups of 64 fixed rows, the fixed tiles loaded once and
// the streamed tiles through a ring of mbarrier-guarded stages by TMA
// from 4-D maps over the [B, T, H, D] views, the producer's lanes
// copying the streamed lse and delta (or bias) values;
//   - dK/dV pass: a warpgroup owns 64 keys; S^T = K Q^T and dP^T = V
//     dO^T are wgmma from shared memory (K-major), P^T and dS^T are
//     formed in registers with the forward's dropout bits, and dV +=
//     P_drop^T dO, dK += dS^T Q are wgmma with A from registers and B
//     (dO, Q) MN-major;
//   - dQ pass: a warpgroup owns 64 queries; S = Q K^T, dP = dO V^T,
//     then dQ += dS K with B = the K tile MN-major;
//   - in both, while the exponentials of tile i run, the products of
//     tile i - 1 and dP of tile i are in flight; the last tile is a
//     separate instantiation of the step, so that no product sits on a
//     branch (the compiler serializes products on divergent paths);
//     masks and dropout are branches outside the element loops.
// At D = 64 the passes take 32-row streamed tiles, one warpgroup a
// block and 3 blocks an SM (the fastest shape measured,
// tools/torch_flash_tune.py); at D = 128, 32-query tiles in the dK/dV
// pass keep dK, dV, S^T and dP^T in registers without spills.  What
// holds it back: the dropout hash, computed in both passes, and the
// exponentials, on ~10 issue slots an element each.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "dropout_hash.cuh"
#include "hopper_wgmma.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;  // fixed-tile rows: 16 a warp
constexpr int kTile = 32;           // streamed rows a tile

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
  const long long* seed;  // dropout seed in [0, 2^32), on the device
  uint32_t g_offset;
  uint32_t threshold;
  float inv_keep;
};

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

template <typename Elt, int D>
constexpr size_t smem_bytes() {
  // two fixed [kRows][kLd] tiles, two streamed [2][kTile][kLd] rings,
  // two [2][kTile] f32 rings, one [kRows] f32 row (the dK/dV pass: K, V;
  // Q, dO; lse, delta; bias -- the dQ pass: Q, dO; K, V; bias; unused)
  return (size_t)(2 * kRows + 4 * kTile) * TileShape<Elt, D>::kLd *
             sizeof(Elt) +
         (size_t)(4 * kTile + kRows) * sizeof(float);
}

// 2. dK, dV (and the bias cotangent) for one (batch*head, 64-key tile)
template <typename Elt, int D>
__global__ void __launch_bounds__(kThreads, D > 64 ? 1 : 3)
    flash_bwd_dkv(const Params p) {
  using Sh = TileShape<Elt, D>;
  constexpr int kLd = Sh::kLd;
  constexpr int kD8 = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Elt* ks = (Elt*)smem_raw;        // [kRows][kLd] this block's keys
  Elt* vs = ks + kRows * kLd;      // [kRows][kLd]
  Elt* qs = vs + kRows * kLd;       // [2][kTile][kLd] query tiles
  Elt* dos = qs + 2 * kTile * kLd;  // [2][kTile][kLd]
  float* lse_s = (float*)(dos + 2 * kTile * kLd);  // [2][kTile]
  float* delta_s = lse_s + 2 * kTile;              // [2][kTile]
  float* bias_s = delta_s + 2 * kTile;             // [kRows]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the dropout seed, read from device memory (a replayed CUDA
  // graph draws the masks of each replay's seed)
  const uint32_t seed = p.dropout ? (uint32_t)__ldg(p.seed) : 0u;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x / p.tiles;
  const int k0 = (blockIdx.x - bh * p.tiles) * kRows;
  const int b = bh / p.heads, h = bh - b * p.heads;
  const int t_len = p.t_len;
  const float* lse_row = p.lse + (long long)bh * t_len;
  const float* delta_row = p.delta + (long long)bh * t_len;

  copy_rows<Elt, D, kRows, kThreads>(ks, p.k, p.sk, b, h, k0, t_len, tid);
  copy_rows<Elt, D, kRows, kThreads>(vs, p.v, p.sv, b, h, k0, t_len, tid);
  if (tid < kRows) {
    const int key = k0 + tid;
    bias_s[tid] = (p.bias && key < t_len)
                      ? p.bias[(long long)b * t_len + key] : 0.f;
  }
  const int n_tiles = (t_len + kTile - 1) / kTile;
  // causal: queries before this key tile see none of its keys
  const int first = p.causal ? k0 / kTile : 0;
  auto issue = [&](int tile, int stage) {
    const int q0 = tile * kTile;
    copy_rows<Elt, D, kTile, kThreads>(qs + stage * kTile * kLd, p.q, p.sq,
                                       b, h, q0, t_len, tid);
    copy_rows<Elt, D, kTile, kThreads>(dos + stage * kTile * kLd, p.dout,
                                       p.sdo, b, h, q0, t_len, tid);
    copy_vec<kTile, kThreads>(lse_s + stage * kTile, lse_row, q0, t_len,
                              tid);
    copy_vec<kTile, kThreads>(delta_s + stage * kTile, delta_row, q0, t_len,
                              tid);
  };
  issue(first, 0);
  cp_commit();

  const int kr = warp * 16;  // this warp's keys in the tile
  float dk[kD8][4], dv[kD8][4], db[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kD8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
  }

  for (int tile = first; tile < n_tiles; ++tile) {
    const int stage = (tile - first) & 1;
    if (tile + 1 < n_tiles) issue(tile + 1, stage ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const Elt* qt = qs + stage * kTile * kLd;
    const Elt* dot = dos + stage * kTile * kLd;
    const float* lse_t = lse_s + stage * kTile;
    const float* delta_t = delta_s + stage * kTile;
    const int q0 = tile * kTile;
    // S^T = K Q^T and dP^T = V dO^T for 16 keys x 32 queries
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kD8; ++kk) {
      const FragA ka = tile_a(ks, kLd, kr, kk * 8, g, t4);
      const FragA va = tile_a(vs, kLd, kr, kk * 8, g, t4);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        mma3(st[n], ka, tile_bt(qt, kLd, n * 8, kk * 8, g, t4));
        mma3(dpt[n], va, tile_bt(dot, kLd, n * 8, kk * 8, g, t4));
      }
    }
    // P (dropped) and dS in place, element by element
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = kr + g + (e >> 1) * 8;
        const int key = k0 + kl;
        const int qi = n * 8 + 2 * t4 + (e & 1);
        const int qpos = q0 + qi;
        float x = st[n][e] * p.scale + bias_s[kl];
        const bool live = qpos < t_len && key < t_len &&
                          !(p.causal && qpos < key);
        const float pr = live && isfinite(x) ? __expf(x - lse_t[qi]) : 0.f;
        float pu = pr, dpu = dpt[n][e];
        if (p.dropout) {
          const bool keep = dropout_keep(seed, (uint32_t)bh + p.g_offset,
                                         (uint32_t)qpos, (uint32_t)key,
                                         p.threshold);
          pu = keep ? pr * p.inv_keep : 0.f;
          dpu = keep ? dpu * p.inv_keep : 0.f;
        }
        const float ds = pr * (dpu - delta_t[qi]);
        db[e >> 1] += ds;
        st[n][e] = pu;
        dpt[n][e] = ds;
      }
    }
    // dV += P^T dO, dK += dS^T Q over the tile's 32 queries
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const FragA pa = acc_a(st[n]);
      const FragA sa = acc_a(dpt[n]);
#pragma unroll
      for (int dt = 0; dt < kD8; ++dt) {
        mma3(dv[dt], pa, tile_b_perm(dot, kLd, n * 8, dt * 8, g, t4));
        mma3(dk[dt], sa, tile_b_perm(qt, kLd, n * 8, dt * 8, g, t4));
      }
    }
    __syncthreads();  // this stage is read before the next issue fills it
  }
  cp_wait<0>();

  // the bias cotangent of a key sums ds over all queries: the 4 lanes of
  // a quad hold disjoint query sets
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    db[r] += __shfl_xor_sync(0xffffffffu, db[r], 1);
    db[r] += __shfl_xor_sync(0xffffffffu, db[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + kr + g + 8 * r;
    if (key >= t_len) continue;
    Elt* dkg = (Elt*)p.dk + row_off(p.sdk, b, key, h);
    Elt* dvg = (Elt*)p.dv + row_off(p.sdv, b, key, h);
#pragma unroll
    for (int dt = 0; dt < kD8; ++dt) {
      const int col = dt * 8 + 2 * t4;
      store2(dkg + col, dk[dt][2 * r] * p.scale, dk[dt][2 * r + 1] * p.scale);
      store2(dvg + col, dv[dt][2 * r], dv[dt][2 * r + 1]);
    }
    if (p.dbias && t4 == 0) p.dbias[(long long)bh * t_len + key] = db[r];
  }
}

// 3. dQ for one (batch*head, 64-query tile)
template <typename Elt, int D>
__global__ void __launch_bounds__(kThreads, D > 64 ? 1 : 3)
    flash_bwd_dq(const Params p) {
  using Sh = TileShape<Elt, D>;
  constexpr int kLd = Sh::kLd;
  constexpr int kD8 = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Elt* qs = (Elt*)smem_raw;        // [kRows][kLd] this block's queries
  Elt* dos = qs + kRows * kLd;     // [kRows][kLd]
  Elt* ks = dos + kRows * kLd;      // [2][kTile][kLd] key tiles
  Elt* vs = ks + 2 * kTile * kLd;   // [2][kTile][kLd]
  float* bias_s = (float*)(vs + 2 * kTile * kLd);  // [2][kTile]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the dropout seed, read from device memory (a replayed CUDA
  // graph draws the masks of each replay's seed)
  const uint32_t seed = p.dropout ? (uint32_t)__ldg(p.seed) : 0u;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x / p.tiles;
  const int q0 = (blockIdx.x - bh * p.tiles) * kRows;
  const int b = bh / p.heads, h = bh - b * p.heads;
  const int t_len = p.t_len;
  const float* bias_row = p.bias ? p.bias + (long long)b * t_len : nullptr;

  copy_rows<Elt, D, kRows, kThreads>(qs, p.q, p.sq, b, h, q0, t_len, tid);
  copy_rows<Elt, D, kRows, kThreads>(dos, p.dout, p.sdo, b, h, q0, t_len,
                                     tid);
  const int qr = warp * 16;  // this warp's queries in the tile
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + qr + g + 8 * r;
    const long long off = (long long)bh * t_len + row;
    lse[r] = row < t_len ? p.lse[off] : 0.f;
    delta[r] = row < t_len ? p.delta[off] : 0.f;
  }
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
  issue(0, 0);
  cp_commit();

  float dq[kD8][4];
#pragma unroll
  for (int i = 0; i < kD8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[i][e] = 0.f;
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
    // S = Q K^T and dP = dO V^T for 16 queries x 32 keys
    float s[4][4], dp[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kD8; ++kk) {
      const FragA qa = tile_a(qs, kLd, qr, kk * 8, g, t4);
      const FragA da = tile_a(dos, kLd, qr, kk * 8, g, t4);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        mma3(s[n], qa, tile_bt(kt, kLd, n * 8, kk * 8, g, t4));
        mma3(dp[n], da, tile_bt(vt, kLd, n * 8, kk * 8, g, t4));
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int qpos = q0 + qr + g + 8 * r;
        const int kl = n * 8 + 2 * t4 + (e & 1);
        const int key = k0 + kl;
        float x = s[n][e] * p.scale + (bias_row ? bias_t[kl] : 0.f);
        const bool live = qpos < t_len && key < t_len &&
                          !(p.causal && qpos < key);
        const float pr = live && isfinite(x) ? __expf(x - lse[r]) : 0.f;
        float dpu = dp[n][e];
        if (p.dropout)
          dpu = dropout_keep(seed, (uint32_t)bh + p.g_offset,
                             (uint32_t)qpos,
                             (uint32_t)key, p.threshold)
                    ? dpu * p.inv_keep
                    : 0.f;
        s[n][e] = pr * (dpu - delta[r]);
      }
    }
    // dQ += dS K over the tile's 32 keys
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const FragA sa = acc_a(s[n]);
#pragma unroll
      for (int dt = 0; dt < kD8; ++dt)
        mma3(dq[dt], sa, tile_b_perm(kt, kLd, n * 8, dt * 8, g, t4));
    }
    __syncthreads();  // this stage is read before the next issue fills it
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + qr + g + 8 * r;
    if (row >= t_len) continue;
    Elt* dqg = (Elt*)p.dq + row_off(p.sdq, b, row, h);
#pragma unroll
    for (int dt = 0; dt < kD8; ++dt)
      store2(dqg + dt * 8 + 2 * t4, dq[dt][2 * r] * p.scale,
             dq[dt][2 * r + 1] * p.scale);
  }
}

// ------------------------------------------------------- bf16 route

struct MapsBwd {  // TMA maps of one pass: its fixed and streamed tiles
  CUtensorMap fixed_a, fixed_b, stream_a, stream_b;
};

// a block of the bf16 route's passes: NWG consumer warpgroups of 64
// fixed rows (keys in the dK/dV pass, queries in the dQ pass) and one
// producer warp; BS rows a streamed tile, kStages tiles in flight
template <int D, int NWG, int BS>
struct BwdShape {
  static constexpr int kRows = NWG * 64;
  static constexpr int kThreads = NWG * 128 + 32;
  static constexpr int kStages = D == 128 ? 2 : 4;
  static constexpr int kTile = BS * D * 2;  // bytes of a streamed tile
  // 1 KB of slack for the 1024-byte alignment, the two fixed tiles, the
  // two streamed rings, two f32 rings [kStages][BS]
  static constexpr size_t kSmem = 1024 + (size_t)2 * kRows * D * 2 +
                                  (size_t)2 * kStages * kTile +
                                  (size_t)2 * kStages * BS * 4;
};

// 2b. dK, dV (and the bias cotangent) for one (batch*head, NWG * 64
// keys), bf16 operands: K and V loaded once, Q, dO, lse and delta
// streamed in BM-query tiles
template <int D, int NWG, int BM, int MINB>
__global__ void __launch_bounds__(NWG * 128 + 32, MINB)
    flash_bwd_dkv_bf16(const __grid_constant__ MapsBwd maps,
                       const Params p) {
  using Sh = BwdShape<D, NWG, BM>;
  constexpr int kStages = Sh::kStages;
  extern __shared__ unsigned char smem_tma[];
  const uint32_t ks = (smem_u32(smem_tma) + 1023) & ~1023u;
  const uint32_t vs = ks + Sh::kRows * D * 2;
  const uint32_t qs = vs + Sh::kRows * D * 2;     // [kStages] query tiles
  const uint32_t dos = qs + kStages * Sh::kTile;  // [kStages] dO tiles
  float* lse_s = (float*)(smem_tma + (dos + kStages * Sh::kTile -
                                      smem_u32(smem_tma)));  // [kStages][BM]
  float* delta_s = lse_s + kStages * BM;                     // [kStages][BM]
  __shared__ uint64_t kv_full, full[kStages], empty[kStages];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the dropout seed, read from device memory (a replayed CUDA
  // graph draws the masks of each replay's seed)
  const uint32_t seed = p.dropout ? (uint32_t)__ldg(p.seed) : 0u;
  const int bh = blockIdx.x / p.tiles;
  const int k0 = (blockIdx.x - bh * p.tiles) * Sh::kRows;
  const int b = bh / p.heads, h = bh - b * p.heads;
  const int t_len = p.t_len;
  const int n_tiles = (t_len + BM - 1) / BM;
  // causal: queries before this key tile see none of its keys
  const int first = p.causal ? k0 / BM : 0;

  if (tid == 0) {
    mbar_init(&kv_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 33);  // the producer's expect_tx and lanes
      mbar_init(&empty[s], NWG * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == NWG * 4) {
    // producer: K and V once, then Q, dO, lse and delta tile by tile;
    // lane 0 issues the TMA loads first, then every lane copies its part
    // of lse and delta
    const float* lse_row = p.lse + (long long)bh * t_len;
    const float* delta_row = p.delta + (long long)bh * t_len;
    if (lane == 0) {
      mbar_expect_tx(&kv_full, 2 * Sh::kRows * D * 2);
      tma_tile<D>(ks, Sh::kRows, &maps.fixed_a, &kv_full, b, h, k0);
      tma_tile<D>(vs, Sh::kRows, &maps.fixed_b, &kv_full, b, h, k0);
    }
    for (int tile = first; tile < n_tiles; ++tile) {
      const int i = tile - first, s = i % kStages, q0 = tile * BM;
      if (i >= kStages) mbar_wait(&empty[s], (i / kStages + 1) & 1);
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * Sh::kTile);
        tma_tile<D>(qs + s * Sh::kTile, BM, &maps.stream_a, &full[s], b, h,
                    q0);
        tma_tile<D>(dos + s * Sh::kTile, BM, &maps.stream_b, &full[s], b,
                    h, q0);
      }
      for (int j = lane; j < BM; j += 32) {
        const bool in = q0 + j < t_len;
        lse_s[s * BM + j] = in ? lse_row[q0 + j] : 0.f;
        delta_s[s * BM + j] = in ? delta_row[q0 + j] : 0.f;
      }
      mbar_arrive(&full[s]);
    }
    return;
  }

  // consumers: warpgroup wg owns keys k0 + 64 wg ..; this lane keys g
  // and g + 8 of its warp's 16
  const int wg = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  const int kr = wg * 64 + (warp & 3) * 16;
  const float scale2 = p.scale * kLog2e;
  float bias2[2];  // the keys' bias times log2(e)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + kr + g + 8 * r;
    bias2[r] = p.bias && key < t_len
                   ? p.bias[(long long)b * t_len + key] * kLog2e
                   : 0.f;
  }
  float dk[D / 2], dv[D / 2], db[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  // S^T = K Q^T and dP^T = V dO^T of a tile (64 keys x BM queries),
  // issued and committed as two groups
  auto issue_s = [&](float (&st)[BM / 2], float (&dpt)[BM / 2], int i) {
    const uint32_t qt = qs + (i % kStages) * Sh::kTile;
    const uint32_t dot = dos + (i % kStages) * Sh::kTile;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<0>(st, desc_k<D>(ks, Sh::kRows, wg * 64, kk),
                  desc_k<D>(qt, BM, 0, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<0>(dpt, desc_k<D>(vs, Sh::kRows, wg * 64, kk),
                  desc_k<D>(dot, BM, 0, kk), kk > 0);
    wgmma_commit();
  };

  // While the exps of tile i run, the products dV, dK of tile i - 1 and
  // dP^T of tile i are in flight; a stage is released once dV and dK
  // of its tile have completed.
  float st[BM / 2], dpt[BM / 2];
  uint32_t pf[BM / 16][4], sf[BM / 16][4];  // P^T, dS^T as A fragments
  CYCLES_BEGIN;
  // a tile's step; `more`: the next tile's products follow (a separate
  // instantiation for the last tile keeps every product on a path all
  // threads take, so the compiler does not serialize them)
  auto step = [&](int tile, auto more) {
    const int i = tile - first, s = i % kStages;
    const float* lse_t = lse_s + s * BM;
    const float* delta_t = delta_s + s * BM;
    const int q0 = tile * BM;
    // a tile with queries past T or, causal, before the warpgroup's
    // last key
    const bool edge = q0 + BM > t_len ||
                      (p.causal && q0 < k0 + wg * 64 + 63);
    wgmma_wait<1>();  // dV, dK of tile i - 1 and S^T of tile i
    CYCLES_STAMP(1);
    fence_acc(st);
    if (i > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(i - 1) % kStages]);
    }
    // P = 2^(s scale log2(e) + bias log2(e) - lse log2(e)), 0 where the
    // query or key is past T or masked (causal); the masks and the
    // dropout are uniform branches taken outside the element loops
    auto probs = [&](auto masked) {
#pragma unroll
      for (int n = 0; n < BM / 8; ++n) {
        const float2 lv = *(const float2*)(lse_t + n * 8 + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float x = fmaf((e & 1) ? lv.y : lv.x, -kLog2e,
                         fmaf(st[4 * n + e], scale2, bias2[r]));
          if constexpr (decltype(masked)::value) {
            const int key = k0 + kr + g + 8 * r;
            const int qpos = q0 + n * 8 + 2 * t4 + (e & 1);
            if (qpos >= t_len || key >= t_len || (p.causal && qpos < key))
              x = -INFINITY;
          }
          st[4 * n + e] = exp2_approx(x);
        }
      }
    };
    if (edge)
      probs(std::true_type());
    else
      probs(std::false_type());
    CYCLES_STAMP(2);
    wgmma_wait<0>();  // dP^T of tile i
    CYCLES_STAMP(3);
    fence_acc(dpt);
    // dS = P (dP_drop - delta), P dropped for dV; in f32
    auto grads = [&](auto drop) {
#pragma unroll
      for (int n = 0; n < BM / 8; ++n) {
        const float2 dl = *(const float2*)(delta_t + n * 8 + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float pr = st[4 * n + e];
          float pu = pr, dpu = dpt[4 * n + e];
          if constexpr (decltype(drop)::value) {
            const int key = k0 + kr + g + 8 * r;
            const int qpos = q0 + n * 8 + 2 * t4 + (e & 1);
            const bool keep = dropout_keep(
                seed, (uint32_t)bh + p.g_offset, (uint32_t)qpos,
                (uint32_t)key, p.threshold);
            pu = keep ? pr * p.inv_keep : 0.f;
            dpu = keep ? dpu * p.inv_keep : 0.f;
          }
          const float ds = pr * (dpu - ((e & 1) ? dl.y : dl.x));
          db[r] += ds;
          st[4 * n + e] = pu;
          dpt[4 * n + e] = ds;
        }
      }
    };
    if (p.dropout)
      grads(std::true_type());
    else
      grads(std::false_type());
    CYCLES_STAMP(4);
    // dV += P^T dO, dK += dS^T Q over the tile's queries, 16 a product,
    // P and dS rounded to bf16 as A fragments; then the next tile's S^T
    // and dP^T
#pragma unroll
    for (int j = 0; j < BM / 16; ++j) {
      acc_a16(st, j, pf[j]);
      acc_a16(dpt, j, sf[j]);
    }
    const uint32_t qt = qs + s * Sh::kTile, dot = dos + s * Sh::kTile;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BM / 16; ++j) {
      wgmma_rs<1>(dv, pf[j], desc_mn<D>(dot, BM, j), 1);
      wgmma_rs<1>(dk, sf[j], desc_mn<D>(qt, BM, j), 1);
    }
    wgmma_commit();
    if constexpr (decltype(more)::value) {
      mbar_wait(&full[(i + 1) % kStages], ((i + 1) / kStages) & 1);
      CYCLES_STAMP(5);
      issue_s(st, dpt, i + 1);
    } else {
      wgmma_wait<0>();
    }
  };
  mbar_wait(&kv_full, 0);
  CYCLES_STAMP(0);
  mbar_wait(&full[0], 0);
  wgmma_fence();
  issue_s(st, dpt, 0);  // first < n_tiles: the block's keys are < T
  for (int tile = first; tile + 1 < n_tiles; ++tile)
    step(tile, std::true_type());
  step(n_tiles - 1, std::false_type());
  CYCLES_END(0, warp);
  fence_acc(dk);
  fence_acc(dv);

  // the bias cotangent of a key sums ds over all queries: the 4 lanes of
  // a quad hold disjoint query sets
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    db[r] += __shfl_xor_sync(0xffffffffu, db[r], 1);
    db[r] += __shfl_xor_sync(0xffffffffu, db[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + kr + g + 8 * r;
    if (key >= t_len) continue;
    __nv_bfloat16* dkg = (__nv_bfloat16*)p.dk + row_off(p.sdk, b, key, h);
    __nv_bfloat16* dvg = (__nv_bfloat16*)p.dv + row_off(p.sdv, b, key, h);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const int col = dt * 8 + 2 * t4;
      store2(dkg + col, dk[4 * dt + 2 * r] * p.scale,
             dk[4 * dt + 2 * r + 1] * p.scale);
      store2(dvg + col, dv[4 * dt + 2 * r], dv[4 * dt + 2 * r + 1]);
    }
    if (p.dbias && t4 == 0) p.dbias[(long long)bh * t_len + key] = db[r];
  }
}

// 3b. dQ for one (batch*head, NWG * 64 queries), bf16 operands: Q and dO
// loaded once, K, V and the bias streamed in BN-key tiles
template <int D, int NWG, int BN, int MINB>
__global__ void __launch_bounds__(NWG * 128 + 32, MINB)
    flash_bwd_dq_bf16(const __grid_constant__ MapsBwd maps,
                      const Params p) {
  using Sh = BwdShape<D, NWG, BN>;
  constexpr int kStages = Sh::kStages;
  extern __shared__ unsigned char smem_tma[];
  const uint32_t qs = (smem_u32(smem_tma) + 1023) & ~1023u;
  const uint32_t dos = qs + Sh::kRows * D * 2;
  const uint32_t ks = dos + Sh::kRows * D * 2;   // [kStages] key tiles
  const uint32_t vs = ks + kStages * Sh::kTile;  // [kStages] value tiles
  float* bias_s = (float*)(smem_tma + (vs + kStages * Sh::kTile -
                                       smem_u32(smem_tma)));  // [kStages][BN]
  __shared__ uint64_t qdo_full, full[kStages], empty[kStages];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the dropout seed, read from device memory (a replayed CUDA
  // graph draws the masks of each replay's seed)
  const uint32_t seed = p.dropout ? (uint32_t)__ldg(p.seed) : 0u;
  const int bh = blockIdx.x / p.tiles;
  const int q0 = (blockIdx.x - bh * p.tiles) * Sh::kRows;
  const int b = bh / p.heads, h = bh - b * p.heads;
  const int t_len = p.t_len;
  int n_tiles = (t_len + BN - 1) / BN;
  // causal: keys after this query tile are masked for all of it
  if (p.causal) n_tiles = min(n_tiles, (q0 + Sh::kRows - 1) / BN + 1);

  if (tid == 0) {
    mbar_init(&qdo_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 33);  // the producer's expect_tx and lanes
      mbar_init(&empty[s], NWG * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == NWG * 4) {
    // producer: Q and dO once, then K, V and the bias tile by tile; lane
    // 0 issues the TMA loads first, then every lane copies its part of
    // the bias
    const float* bias_row = p.bias ? p.bias + (long long)b * t_len : nullptr;
    if (lane == 0) {
      mbar_expect_tx(&qdo_full, 2 * Sh::kRows * D * 2);
      tma_tile<D>(qs, Sh::kRows, &maps.fixed_a, &qdo_full, b, h, q0);
      tma_tile<D>(dos, Sh::kRows, &maps.fixed_b, &qdo_full, b, h, q0);
    }
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int s = tile % kStages, k0 = tile * BN;
      if (tile >= kStages) mbar_wait(&empty[s], (tile / kStages + 1) & 1);
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * Sh::kTile);
        tma_tile<D>(ks + s * Sh::kTile, BN, &maps.stream_a, &full[s], b, h,
                    k0);
        tma_tile<D>(vs + s * Sh::kTile, BN, &maps.stream_b, &full[s], b, h,
                    k0);
      }
      for (int j = lane; j < BN; j += 32)
        bias_s[s * BN + j] =
            bias_row && k0 + j < t_len ? bias_row[k0 + j] : 0.f;
      mbar_arrive(&full[s]);
    }
    return;
  }

  const int wg = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  const int qr = wg * 64 + (warp & 3) * 16;
  const float scale2 = p.scale * kLog2e;
  float lse2[2], delta[2];  // the rows' lse times log2(e), and delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + qr + g + 8 * r;
    const long long off = (long long)bh * t_len + row;
    lse2[r] = row < t_len ? p.lse[off] * kLog2e : 0.f;
    delta[r] = row < t_len ? p.delta[off] : 0.f;
  }
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  // S = Q K^T and dP = dO V^T of a tile (64 queries x BN keys), issued
  // and committed as two groups
  auto issue_s = [&](float (&sc)[BN / 2], float (&dp)[BN / 2], int tile) {
    const uint32_t kt = ks + (tile % kStages) * Sh::kTile;
    const uint32_t vt = vs + (tile % kStages) * Sh::kTile;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<0>(sc, desc_k<D>(qs, Sh::kRows, wg * 64, kk),
                  desc_k<D>(kt, BN, 0, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<0>(dp, desc_k<D>(dos, Sh::kRows, wg * 64, kk),
                  desc_k<D>(vt, BN, 0, kk), kk > 0);
    wgmma_commit();
  };

  // While the exps of tile j run, dQ += dS K of tile j - 1 and dP of
  // tile j are in flight; a stage is released once its dQ product has
  // completed.
  float sc[BN / 2], dp[BN / 2];
  uint32_t sf[BN / 16][4];  // dS as A fragments
  CYCLES_BEGIN;
  // a tile's step; `more` as in the dK/dV pass
  auto step = [&](int tile, auto more) {
    const int s = tile % kStages;
    const float* bias_t = bias_s + s * BN;
    const int k0 = tile * BN;
    // a tile with keys past T or, causal, past the warpgroup's first
    // query; rows past T stay unmasked (they are not stored)
    const bool edge = k0 + BN > t_len ||
                      (p.causal && k0 + BN - 1 > q0 + wg * 64);
    wgmma_wait<1>();  // dQ of tile - 1 and S of this tile
    CYCLES_STAMP(1);
    fence_acc(sc);
    if (tile > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(tile - 1) % kStages]);
    }
    // the masks and the dropout are uniform branches taken outside the
    // element loops
    auto probs = [&](auto masked) {
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        const float2 bv = *(const float2*)(bias_t + n * 8 + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float x = fmaf((e & 1) ? bv.y : bv.x, kLog2e,
                         fmaf(sc[4 * n + e], scale2, -lse2[r]));
          if constexpr (decltype(masked)::value) {
            const int qpos = q0 + qr + g + 8 * r;
            const int key = k0 + n * 8 + 2 * t4 + (e & 1);
            if (key >= t_len || (p.causal && qpos < key)) x = -INFINITY;
          }
          sc[4 * n + e] = exp2_approx(x);
        }
      }
    };
    if (edge)
      probs(std::true_type());
    else
      probs(std::false_type());
    CYCLES_STAMP(2);
    wgmma_wait<0>();  // dP of this tile
    CYCLES_STAMP(3);
    fence_acc(dp);
    auto grads = [&](auto drop) {
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float dpu = dp[4 * n + e];
          if constexpr (decltype(drop)::value) {
            const int qpos = q0 + qr + g + 8 * r;
            const int key = k0 + n * 8 + 2 * t4 + (e & 1);
            dpu = dropout_keep(seed, (uint32_t)bh + p.g_offset,
                               (uint32_t)qpos, (uint32_t)key, p.threshold)
                      ? dpu * p.inv_keep
                      : 0.f;
          }
          sc[4 * n + e] *= dpu - delta[r];
        }
      }
    };
    if (p.dropout)
      grads(std::true_type());
    else
      grads(std::false_type());
    CYCLES_STAMP(4);
    // dQ += dS K over the tile's keys, dS rounded to bf16; then the next
    // tile's S and dP
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) acc_a16(sc, j, sf[j]);
    const uint32_t kt = ks + s * Sh::kTile;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BN / 16; ++j)
      wgmma_rs<1>(dq, sf[j], desc_mn<D>(kt, BN, j), 1);
    wgmma_commit();
    if constexpr (decltype(more)::value) {
      mbar_wait(&full[(tile + 1) % kStages], ((tile + 1) / kStages) & 1);
      CYCLES_STAMP(5);
      issue_s(sc, dp, tile + 1);
    } else {
      wgmma_wait<0>();
    }
  };
  mbar_wait(&qdo_full, 0);
  CYCLES_STAMP(0);
  mbar_wait(&full[0], 0);
  wgmma_fence();
  issue_s(sc, dp, 0);
  for (int tile = 0; tile + 1 < n_tiles; ++tile)
    step(tile, std::true_type());
  step(n_tiles - 1, std::false_type());
  CYCLES_END(1, warp);
  fence_acc(dq);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + qr + g + 8 * r;
    if (row >= t_len) continue;
    __nv_bfloat16* dqg = (__nv_bfloat16*)p.dq + row_off(p.sdq, b, row, h);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      store2(dqg + dt * 8 + 2 * t4, dq[4 * dt + 2 * r] * p.scale,
             dq[4 * dt + 2 * r + 1] * p.scale);
  }
}

// the delta pass, then the dK/dV pass (NWG warpgroups, BM-query tiles)
// and the dQ pass (NWG warpgroups, BN-key tiles)
template <int D, int NWG, int BM, int BN, int MINB = 1>
cudaError_t launch_bf16(const Params& p0, int batch, cudaStream_t stream) {
  using ShKV = BwdShape<D, NWG, BM>;
  using ShQ = BwdShape<D, NWG, BN>;
  static bool dkv_configured[64] = {};
  static bool dq_configured[64] = {};
  cudaError_t e = configure(flash_bwd_dkv_bf16<D, NWG, BM, MINB>,
                            ShKV::kSmem, dkv_configured);
  if (e != cudaSuccess) return e;
  e = configure(flash_bwd_dq_bf16<D, NWG, BN, MINB>, ShQ::kSmem,
                dq_configured);
  if (e == cudaSuccess) e = bind_context();
  if (e != cudaSuccess) return e;
  const int t = p0.t_len, hh = p0.heads, rows = ShKV::kRows;
  MapsBwd kv, q;
  int err = encode_rows<D>(&kv.fixed_a, p0.k, p0.sk.b, p0.sk.t, p0.sk.h,
                           batch, t, hh, rows);
  if (!err)
    err = encode_rows<D>(&kv.fixed_b, p0.v, p0.sv.b, p0.sv.t, p0.sv.h,
                         batch, t, hh, rows);
  if (!err)
    err = encode_rows<D>(&kv.stream_a, p0.q, p0.sq.b, p0.sq.t, p0.sq.h,
                         batch, t, hh, BM);
  if (!err)
    err = encode_rows<D>(&kv.stream_b, p0.dout, p0.sdo.b, p0.sdo.t,
                         p0.sdo.h, batch, t, hh, BM);
  if (!err)
    err = encode_rows<D>(&q.fixed_a, p0.q, p0.sq.b, p0.sq.t, p0.sq.h, batch,
                         t, hh, rows);
  if (!err)
    err = encode_rows<D>(&q.fixed_b, p0.dout, p0.sdo.b, p0.sdo.t, p0.sdo.h,
                         batch, t, hh, rows);
  if (!err)
    err = encode_rows<D>(&q.stream_a, p0.k, p0.sk.b, p0.sk.t, p0.sk.h,
                         batch, t, hh, BN);
  if (!err)
    err = encode_rows<D>(&q.stream_b, p0.v, p0.sv.b, p0.sv.t, p0.sv.h,
                         batch, t, hh, BN);
  if (err) return (cudaError_t)err;
  Params p = p0;
  p.tiles = (t + rows - 1) / rows;
  const long long bh = (long long)batch * hh;
  const long long n_rows = bh * t;
  const long long blocks = bh * p.tiles;
  if (blocks > 0x7fffffffLL || (n_rows + 7) / 8 > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  flash_bwd_delta<__nv_bfloat16>
      <<<(unsigned)((n_rows + 7) / 8), 256, 0, stream>>>(p, D, n_rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkv_bf16<D, NWG, BM, MINB>
      <<<(unsigned)blocks, ShKV::kThreads, ShKV::kSmem, stream>>>(kv, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dq_bf16<D, NWG, BN, MINB>
      <<<(unsigned)blocks, ShQ::kThreads, ShQ::kSmem, stream>>>(q, p);
  return cudaGetLastError();
}

// the bf16 route's block shape at D = 64 (NWG, BM, BN, MINB); a copy
// built with another one defined is how tools/torch_flash_tune.py
// measures it
#ifndef BWD_BF16_SHAPE_D64
#define BWD_BF16_SHAPE_D64 1, 32, 32, 3
#endif

cudaError_t launch_bf16_d(const Params& p, int batch, int d,
                          cudaStream_t stream) {
  switch (d) {
    case 32: return launch_bf16<32, 2, 64, 64>(p, batch, stream);
    case 64: return launch_bf16<64, BWD_BF16_SHAPE_D64>(p, batch, stream);
    case 128: return launch_bf16<128, 1, 32, 64>(p, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename Elt, int D>
cudaError_t launch(const Params& p, long long bh, cudaStream_t stream) {
  static bool dkv_configured[64] = {};
  static bool dq_configured[64] = {};
  const size_t smem = smem_bytes<Elt, D>();
  cudaError_t e = configure(flash_bwd_dkv<Elt, D>, smem, dkv_configured);
  if (e != cudaSuccess) return e;
  e = configure(flash_bwd_dq<Elt, D>, smem, dq_configured);
  if (e != cudaSuccess) return e;
  const long long rows = bh * p.t_len;
  const long long blocks = bh * p.tiles;
  if (blocks > 0x7fffffffLL || (rows + 7) / 8 > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  flash_bwd_delta<Elt><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      p, D, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkv<Elt, D><<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dq<Elt, D><<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_d(const Params& p, int batch, int d, int dtype,
                     cudaStream_t stream) {
  const long long bh = (long long)batch * p.heads;
  if (dtype == 0) {
    switch (d) {
      case 32: return launch<float, 32>(p, bh, stream);
      case 64: return launch<float, 64>(p, bh, stream);
      case 128: return launch<float, 128>(p, bh, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) return launch_bf16_d(p, batch, d, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: [B, T, H, D] addressed by `strides` (24
// element strides: b, t, h of each in that order; the d stride is 1);
// q, k, v and dout start on 16 bytes and their rows on 16-byte
// multiples.  key_bias: [B, T] f32 contiguous or null.  lse, glse (or
// null), delta (scratch), dbias (or null): [B*H, T] f32 contiguous.
// dtype: 0 = f32 (3xTF32 products), 1 = bf16 (bf16 products, the
// Pallas kernel's rounding points).  D: 32, 64 or 128.  dropout: 0, or
// 1 with the address of the forward's seed (an int64 in [0, 2^32) in
// device memory), head-index offset, 24-bit keep threshold and
// 1 / (1 - rate).
// Launches the delta, dK/dV and dQ kernels in that order on `stream`;
// returns the first CUDA error (0 on success).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* key_bias, const float* lse,
    const float* glse, float* delta, void* dq, void* dk, void* dv,
    float* dbias, int batch, int heads, int t_len, int d, int dtype,
    int causal, float scale, const long long* strides, int dropout,
    const long long* seed, uint32_t g_offset, uint32_t threshold,
    float inv_keep, void* stream) {
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
  p.tiles = (t_len + kRows - 1) / kRows;
  p.scale = scale;
  p.causal = causal;
  p.dropout = dropout;
  p.seed = seed;
  p.g_offset = g_offset;
  p.threshold = threshold;
  p.inv_keep = inv_keep;
  const int elt = dtype == 0 ? 4 : 2;
  if (!copy_aligned(q, p.sq, elt) || !copy_aligned(k, p.sk, elt) ||
      !copy_aligned(v, p.sv, elt) || !copy_aligned(dout, p.sdo, elt))
    return (int)cudaErrorMisalignedAddress;
  return (int)launch_d(p, batch, d, dtype, (cudaStream_t)stream);
}

extern "C" const char* cuda_error_string(int err) {
  const char* s = hopper_error_string(err);
  return s ? s : cudaGetErrorString((cudaError_t)err);
}
