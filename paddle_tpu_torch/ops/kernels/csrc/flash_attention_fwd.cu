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
// the bf16 operands with f32 accumulation, the online softmax in f32
// with l summing the unrounded p, the dropped p scaled by 1 / (1 - rate)
// and rounded to bf16 as the A operand of P V, O rounded once to bf16
// and lse in f32.  Bound at BERT-base (B=8, H=12, T=512, D=64): the 25
// MB of bf16 Q, K, V, O and the f32 lse and bias take 0.0076 ms at 3.35
// TB/s, above the operations' 6.44 GFLOP at 989 TFLOP/s bf16 (0.0065
// ms), so bytes bound it.  Design, for Hopper (hopper_wgmma.cuh):
//   - a block of one producer warp and NWG consumer warpgroups of 64
//     query rows (at D = 64 one warpgroup, 3 blocks an SM: the fastest
//     of the shapes measured, tools/torch_flash_tune.py);
//   - the producer's lane 0 loads the Q tile once and K and V in tiles
//     of BN = 64 keys by TMA from 4-D maps over the [B, T, H, D] views
//     (no copy of the fused projection's views; rows past T read 0)
//     into 128-byte-swizzled shared memory (64-byte at D = 32, two
//     boxes at D = 128), through a ring of 3-4 stages, each with a full
//     and an empty mbarrier; its lanes copy the tile's bias;
//   - S = Q K^T is wgmma m64n64k16 from shared memory (both operands
//     K-major); O += P V is wgmma with A = P from registers (two
//     adjacent 8-column accumulator blocks, rounded to bf16, are one k16
//     A fragment) and B = the V tile read MN-major (transpose bit);
//   - each warpgroup overlaps its softmax with its products: S of tile
//     j and P V of tile j - 1 are issued together, the exponentials of
//     tile j run while P V is in flight, and a stage is released once
//     its P V has completed;
//   - the softmax in the accumulator layout (rows g and g + 8 of each
//     warp's 16, columns 2t, 2t + 1 of each 8): the exponentials as
//     2^(x log2(e) - m log2(e)) on the MUFU, the key masks only on the
//     tiles that need them and the dropout hash only with dropout, both
//     branches taken outside the element loops (a branch an element
//     tripled the softmax's time), each element's keep bit the counter
//     hash at its own (head, query, key), as in the f32 route.
// No atomics: a second launch gives the same O and lse bit for bit.
// What holds it back: at 26% of the byte bound, the softmax's issue
// slots and MUFU exponentials (and the dropout hash), and each block's
// first Q and K/V loads from cold HBM (~2 us a block).

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
  const long long* seed;  // dropout seed in [0, 2^32), on the device
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
  // the dropout seed, read from device memory (a replayed CUDA
  // graph draws the masks of each replay's seed)
  const uint32_t seed = p.dropout ? (uint32_t)__ldg(p.seed) : 0u;
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
          pu = dropout_keep(seed, (uint32_t)bh + p.g_offset,
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

struct MapsFwd {  // TMA maps of q, k, v: boxes of query / key tiles
  CUtensorMap q, k, v;
};

// the bf16 route's block: NWG consumer warpgroups of 64 query rows and
// one producer warp; BN keys a streamed tile, kStages tiles in flight;
// MINB blocks an SM asked of the register allocation
template <int D, int NWG, int BN, int MINB>
struct FwdShape {
  static constexpr int kRows = NWG * 64;
  static constexpr int kThreads = NWG * 128 + 32;
  static constexpr int kStages = D == 128 || NWG > 1 ? 3 : 4;
  static constexpr int kTile = BN * D * 2;  // bytes of a K or V tile
  // 1 KB of slack to put the tiles on 1024 bytes, the Q tile, the K
  // and V rings, the bias ring [kStages][BN] f32
  static constexpr size_t kSmem = 1024 + (size_t)kRows * D * 2 +
                                  (size_t)2 * kStages * kTile +
                                  (size_t)kStages * BN * 4;
};

template <int D, int NWG, int BN, int MINB>
__global__ void __launch_bounds__(NWG * 128 + 32, MINB)
    flash_fwd_bf16(const __grid_constant__ MapsFwd maps, const Params p) {
  using Sh = FwdShape<D, NWG, BN, MINB>;
  constexpr int kStages = Sh::kStages;
  extern __shared__ unsigned char smem_tma[];
  const uint32_t qs = (smem_u32(smem_tma) + 1023) & ~1023u;
  const uint32_t ks = qs + Sh::kRows * D * 2;   // [kStages] key tiles
  const uint32_t vs = ks + kStages * Sh::kTile;  // [kStages] value tiles
  float* bias_s = (float*)(smem_tma + (vs + kStages * Sh::kTile -
                                       smem_u32(smem_tma)));  // [kStages][BN]
  __shared__ uint64_t q_full, full[kStages], empty[kStages];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the dropout seed, read from device memory (a replayed CUDA
  // graph draws the masks of each replay's seed)
  const uint32_t seed = p.dropout ? (uint32_t)__ldg(p.seed) : 0u;
  const int bh = blockIdx.x / p.q_tiles;
  const int q0 = (blockIdx.x - bh * p.q_tiles) * Sh::kRows;
  const int b = bh / p.heads, h = bh - b * p.heads;
  const int t_len = p.t_len;
  int n_tiles = (t_len + BN - 1) / BN;
  if (p.causal) n_tiles = min(n_tiles, (q0 + Sh::kRows - 1) / BN + 1);

  if (tid == 0) {
    mbar_init(&q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 33);  // the producer's expect_tx and lanes
      mbar_init(&empty[s], NWG * 4);  // one lane of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == NWG * 4) {
    // producer: Q once, then K, V and the bias tile by tile, a stage
    // refilled once its consumers have released it; lane 0 issues the
    // TMA loads first, then every lane copies its part of the bias
    const float* bias_row = p.bias ? p.bias + (long long)b * t_len : nullptr;
    if (lane == 0) {
      mbar_expect_tx(&q_full, Sh::kRows * D * 2);
      tma_tile<D>(qs, Sh::kRows, &maps.q, &q_full, b, h, q0);
    }
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int s = tile % kStages, k0 = tile * BN;
      if (tile >= kStages) mbar_wait(&empty[s], (tile / kStages + 1) & 1);
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * Sh::kTile);
        tma_tile<D>(ks + s * Sh::kTile, BN, &maps.k, &full[s], b, h, k0);
        tma_tile<D>(vs + s * Sh::kTile, BN, &maps.v, &full[s], b, h, k0);
      }
      for (int i = lane; i < BN; i += 32)
        bias_s[s * BN + i] =
            bias_row && k0 + i < t_len ? bias_row[k0 + i] : 0.f;
      mbar_arrive(&full[s]);
    }
    return;
  }

  // consumers: warpgroup wg owns queries q0 + 64 wg ..; this lane rows
  // g and g + 8 of its warp's 16
  const int wg = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  const int qr = wg * 64 + (warp & 3) * 16;
  float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  // the online softmax of tile `tile`'s scores in sc: x = s * scale +
  // bias, the rows' max m over the quad, p = 2^(x log2(e) - m log2(e));
  // m and l move on, corr is the factor O's rows take, and sc is left
  // holding P in f32, dropped and rescaled (l sums the unrounded,
  // un-dropped values)
  auto softmax = [&](float (&sc)[BN / 2], int tile, float (&corr)[2]) {
    const float* bias_t = bias_s + (tile % kStages) * BN;
    const int k0 = tile * BN;
    // a tile with keys past T or, causal, past the warpgroup's first query
    const bool edge = k0 + BN > t_len ||
                      (p.causal && k0 + BN - 1 > q0 + wg * 64);
    // the masks and the dropout are uniform branches taken outside the
    // element loops (a branch an element serializes the exponentials)
    float mx[2] = {-INFINITY, -INFINITY};
    auto scores = [&](auto masked) {
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        const float2 bv = *(const float2*)(bias_t + n * 8 + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float x = fmaf(sc[4 * n + e], p.scale, (e & 1) ? bv.y : bv.x);
          if constexpr (decltype(masked)::value) {
            const int key = k0 + n * 8 + 2 * t4 + (e & 1);
            const int qpos = q0 + qr + g + 8 * r;
            if (key >= t_len || (p.causal && qpos < key)) x = -INFINITY;
          }
          sc[4 * n + e] = x;
          mx[r] = fmaxf(mx[r], x);
        }
      }
    };
    if (edge)
      scores(std::true_type());
    else
      scores(std::false_type());
    float m2[2];  // -m_safe log2(e)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_i[r], mx[r]);
      m2[r] = isfinite(m_new) ? -m_new * kLog2e : 0.f;
      corr[r] = exp2_approx(fmaf(m_i[r], kLog2e, m2[r]));  // 0: m_i -inf
      m_i[r] = m_new;
      l_i[r] *= corr[r];
    }
    auto probs = [&](auto drop) {
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float pr = exp2_approx(fmaf(sc[4 * n + e], kLog2e, m2[r]));
          l_i[r] += pr;
          float pu = pr;
          if constexpr (decltype(drop)::value) {
            const int key = k0 + n * 8 + 2 * t4 + (e & 1);
            const int qpos = q0 + qr + g + 8 * r;
            pu = dropout_keep(seed, (uint32_t)bh + p.g_offset,
                              (uint32_t)qpos, (uint32_t)key, p.threshold)
                     ? pr * p.inv_keep
                     : 0.f;
          }
          sc[4 * n + e] = pu;
        }
      }
    };
    if (p.dropout)
      probs(std::true_type());
    else
      probs(std::false_type());
  };
  // S = Q K^T of a tile (64 queries x BN keys), issued and committed
  auto issue_s = [&](float (&sc)[BN / 2], int tile) {
    const uint32_t kt = ks + (tile % kStages) * Sh::kTile;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<0>(sc, desc_k<D>(qs, Sh::kRows, wg * 64, kk),
                  desc_k<D>(kt, BN, 0, kk), kk > 0);
    wgmma_commit();
  };
  // O += P V of a tile, P (bf16) from registers, issued and committed
  auto issue_pv = [&](const uint32_t (&pf)[BN / 16][4], int tile) {
    const uint32_t vt = vs + (tile % kStages) * Sh::kTile;
#pragma unroll
    for (int j = 0; j < BN / 16; ++j)
      wgmma_rs<1>(o, pf[j], desc_mn<D>(vt, BN, j), 1);
    wgmma_commit();
  };

  // The products of a warpgroup overlap its softmax: while the exps of
  // tile j run, O += P V of tile j - 1 is in flight.  A stage is released
  // once its P V has completed.
  float sc[BN / 2], corr[2];
  uint32_t pf[BN / 16][4];  // P of the previous tile as A fragments
  CYCLES_BEGIN;
  mbar_wait(&q_full, 0);
  CYCLES_STAMP(0);
  mbar_wait(&full[0], 0);
  wgmma_fence();
  issue_s(sc, 0);
  wgmma_wait<0>();
  fence_acc(sc);
  softmax(sc, 0, corr);
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) acc_a16(sc, j, pf[j]);
  for (int tile = 1; tile < n_tiles; ++tile) {
    mbar_wait(&full[tile % kStages], (tile / kStages) & 1);
    CYCLES_STAMP(1);
    wgmma_fence();
    issue_s(sc, tile);
    issue_pv(pf, tile - 1);
    wgmma_wait<1>();  // S of this tile
    CYCLES_STAMP(2);
    fence_acc(sc);
    softmax(sc, tile, corr);
    CYCLES_STAMP(3);
    wgmma_wait<0>();  // P V of the previous tile
    CYCLES_STAMP(4);
    fence_acc(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[(tile - 1) % kStages]);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      o[4 * dt] *= corr[0];
      o[4 * dt + 1] *= corr[0];
      o[4 * dt + 2] *= corr[1];
      o[4 * dt + 3] *= corr[1];
    }
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) acc_a16(sc, j, pf[j]);
    CYCLES_STAMP(5);
  }
  wgmma_fence();
  issue_pv(pf, n_tiles - 1);
  wgmma_wait<0>();
  fence_acc(o);

  CYCLES_END(0, warp);

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
    __nv_bfloat16* og = (__nv_bfloat16*)p.o + row_off(p.so, b, row, h);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      store2(og + dt * 8 + 2 * t4, o[4 * dt + 2 * r] / l_safe,
             o[4 * dt + 2 * r + 1] / l_safe);
    if (t4 == 0) {
      const float m_fin = isfinite(m_i[r]) ? m_i[r] : 0.f;
      p.lse[(long long)bh * t_len + row] = m_fin + logf(l_safe);
    }
  }
}

template <int D, int NWG, int BN, int MINB = 1>
cudaError_t launch_bf16(const Params& p0, int batch, cudaStream_t stream) {
  using Sh = FwdShape<D, NWG, BN, MINB>;
  static bool configured[64] = {};
  cudaError_t e =
      configure(flash_fwd_bf16<D, NWG, BN, MINB>, Sh::kSmem, configured);
  if (e == cudaSuccess) e = bind_context();
  if (e != cudaSuccess) return e;
  MapsFwd maps;
  int err = encode_rows<D>(&maps.q, p0.q, p0.sq.b, p0.sq.t, p0.sq.h, batch,
                           p0.t_len, p0.heads, Sh::kRows);
  if (!err)
    err = encode_rows<D>(&maps.k, p0.k, p0.sk.b, p0.sk.t, p0.sk.h, batch,
                         p0.t_len, p0.heads, BN);
  if (!err)
    err = encode_rows<D>(&maps.v, p0.v, p0.sv.b, p0.sv.t, p0.sv.h, batch,
                         p0.t_len, p0.heads, BN);
  if (err) return (cudaError_t)err;
  Params p = p0;
  p.q_tiles = (p.t_len + Sh::kRows - 1) / Sh::kRows;
  const long long blocks = (long long)batch * p.heads * p.q_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_fwd_bf16<D, NWG, BN, MINB>
      <<<(unsigned)blocks, Sh::kThreads, Sh::kSmem, stream>>>(maps, p);
  return cudaGetLastError();
}

// the bf16 route's block shape at D = 64 (NWG, BN, MINB); a copy built
// with another one defined is how tools/torch_flash_tune.py measures it
#ifndef FWD_BF16_SHAPE_D64
#define FWD_BF16_SHAPE_D64 1, 64, 3
#endif

cudaError_t launch_bf16_d(const Params& p, int batch, int d,
                          cudaStream_t stream) {
  switch (d) {
    case 32: return launch_bf16<32, 1, 64, 3>(p, batch, stream);
    case 64: return launch_bf16<64, FWD_BF16_SHAPE_D64>(p, batch, stream);
    case 128: return launch_bf16<128, 2, 64>(p, batch, stream);
    default: return cudaErrorInvalidValue;
  }
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

// ------------------------------------------------- wgmma probe

struct MapsProbe {
  CUtensorMap x, y, v;
};

// One block of one warpgroup: X, Y, V ([64, D] bf16 each) loaded by TMA
// as the flash kernels load their tiles; S = X Y^T (wgmma, both operands
// K-major from shared memory) and O = P V (P [64, 64] f32 read from
// global in the accumulator layout, rounded to bf16 as an A fragment
// from registers; V MN-major).  Holds the descriptors and swizzles of
// hopper_wgmma.cuh against a plain matrix product.
template <int D>
__global__ void __launch_bounds__(128)
    wgmma_probe(const __grid_constant__ MapsProbe m, const float* pin,
                float* s_out, float* o_out) {
  using S = SwTile<D>;
  extern __shared__ unsigned char smem_tma[];
  const uint32_t xs = (smem_u32(smem_tma) + 1023) & ~1023u;
  const uint32_t ys = xs + S::bytes(64), vs = ys + S::bytes(64);
  __shared__ uint64_t bar;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2), c0 = 2 * (lane & 3);
  if (tid == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar, 3 * S::bytes(64));
    tma_tile<D>(xs, 64, &m.x, &bar, 0, 0, 0);
    tma_tile<D>(ys, 64, &m.y, &bar, 0, 0, 0);
    tma_tile<D>(vs, 64, &m.v, &bar, 0, 0, 0);
  }
  mbar_wait(&bar, 0);
  float s[32], pa[32], o[D / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<0>(s, desc_k<D>(xs, 64, 0, kk), desc_k<D>(ys, 64, 0, kk),
                kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(s);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = r0 + 8 * ((i >> 1) & 1), c = 8 * (i >> 2) + c0 + (i & 1);
    s_out[r * 64 + c] = s[i];
    pa[i] = pin[r * 64 + c];
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t a[4];
    acc_a16(pa, j, a);
    wgmma_rs<1>(o, a, desc_mn<D>(vs, 64, j), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(o);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    const int r = r0 + 8 * ((i >> 1) & 1), c = 8 * (i >> 2) + c0 + (i & 1);
    o_out[r * D + c] = o[i];
  }
}

template <int D>
cudaError_t launch_probe(const void* x, const void* y, const void* v,
                         const float* p, float* s, float* o,
                         cudaStream_t stream) {
  static bool configured[64] = {};
  const size_t smem = 1024 + 3 * SwTile<D>::bytes(64);
  cudaError_t e = configure(wgmma_probe<D>, smem, configured);
  if (e == cudaSuccess) e = bind_context();
  if (e != cudaSuccess) return e;
  MapsProbe m;  // each a [1, 64, 1, D] contiguous tensor
  int err = encode_rows<D>(&m.x, x, 64 * D, D, D, 1, 64, 1, 64);
  if (!err) err = encode_rows<D>(&m.y, y, 64 * D, D, D, 1, 64, 1, 64);
  if (!err) err = encode_rows<D>(&m.v, v, 64 * D, D, D, 1, 64, 1, 64);
  if (err) return (cudaError_t)err;
  wgmma_probe<D><<<1, 128, smem, stream>>>(m, p, s, o);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: [B, T, H, D] addressed by `strides` (12 element strides:
// q's b, t, h, then k's, v's and o's; the d stride is 1); q, k and v
// start on 16 bytes and their rows on 16-byte multiples.  key_bias:
// [B, T] f32 contiguous or null.  lse: [B*H, T] f32 contiguous.
// dtype: 0 = f32 (3xTF32 products), 1 = bf16 (bf16 products, the
// Pallas kernel's rounding points).  D: 32, 64 or 128.  dropout: 0, or
// 1 with the address of the seed (an int64 in [0, 2^32) in device
// memory, read by every thread at the kernel's start), the 24-bit keep
// threshold and 1 / (1 - rate);
// g_offset shifts the hash's head index b*H + h (a data-parallel rank's
// rows of the global batch start at rank * B * H).
// Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const float* key_bias,
                                   void* o, float* lse, int batch, int heads,
                                   int t_len, int d, int dtype, int causal,
                                   float scale, const long long* strides,
                                   int dropout, const long long* seed,
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
  return (int)launch_d(p, batch, d, dtype, (cudaStream_t)stream);
}

// x, y, v: [64, D] bf16 contiguous (16-byte aligned); p: [64, 64] f32;
// s = x y^T [64, 64] f32 and o = bf16(p) v [64, D] f32, both products
// by wgmma on TMA-loaded tiles.  D: 32, 64 or 128.
extern "C" int hopper_wgmma_probe(const void* x, const void* y,
                                  const void* v, const float* p, float* s,
                                  float* o, int d, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 32: return (int)launch_probe<32>(x, y, v, p, s, o, st);
    case 64: return (int)launch_probe<64>(x, y, v, p, s, o, st);
    case 128: return (int)launch_probe<128>(x, y, v, p, s, o, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* cuda_error_string(int err) {
  const char* s = hopper_error_string(err);
  return s ? s : cudaGetErrorString((cudaError_t)err);
}
