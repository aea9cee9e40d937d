// Hopper (sm_90a) helpers shared by the bf16 routes of the
// flash-attention kernels (flash_attention_fwd.cu, flash_attention_bwd.cu):
// mbarriers, TMA tile loads into swizzled shared memory, the wgmma
// shared-memory matrix descriptor, wgmma.mma_async m64nNk16 with bf16
// operands and f32 accumulators (A from shared memory or from registers,
// B K-major or MN-major), and on the host the CUtensorMap of a
// [B, T, H, D] tensor, encoded through the driver entry point so that
// the plain-C library links no libcuda.
//
// Tiles.  A tile of R rows of one (b, h) of a [B, T, H, D] bf16 tensor
// is loaded by TMA as D / kCols boxes of kCols columns x R rows, box c at
// c * R * kSw bytes, each box R rows of kSw bytes (kSw = 128 for D = 64
// and 128, 64 for D = 32) with the matching swizzle: the 16-byte chunk j
// of row r lands at chunk j ^ (r / (128 / kSw) % (kSw / 16)), the layout
// wgmma reads with the same swizzle mode (CU_TENSOR_MAP_SWIZZLE_128B /
// _64B, descriptor layout 1 / 2).  Rows past T are zero-filled by TMA.
// Every box starts on 1024 bytes.  Such a tile is read by wgmma
//   - K-major (its D is the product's K): rows r0 .. r0 + 63 as A, or all
//     R rows as B; the k16 step kk starts 32 bytes further in its box,
//     8-row groups kSw * 8 bytes apart (SBO);
//   - MN-major (its rows are the product's K, its D the product's N): B
//     of the k16 step j starts at row 16 j, 8-row K groups kSw * 8 bytes
//     apart (SBO), boxes along N R * kSw bytes apart (LBO); the transpose
//     bit of the instruction set (16-bit types allow it).
//
// Fragments (PTX ISA, wgmma .m64nNk16): thread 32 w + 4 g + t of the
// warpgroup holds accumulator rows 16 w + g and 16 w + g + 8, columns
// 8 i + 2 t and 8 i + 2 t + 1 in d[4 i .. 4 i + 3] (row g: d[4 i], d[4 i
// + 1]; row g + 8: d[4 i + 2], d[4 i + 3]), the mma.sync m16n8 C layout
// per warp; an A fragment from registers (16 rows x k16 a warp) is
// mma.sync m16n8k16's: so the accumulator blocks 2 j and 2 j + 1,
// rounded to bf16, are the A fragment of the k16 step j (acc_a16).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, no libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ----------------------------------------------------------- tiles

template <int D>
struct SwTile {
  static constexpr int kSw = D == 32 ? 64 : 128;  // bytes a box row
  static constexpr int kCols = kSw / 2;            // bf16 columns a box
  static constexpr int kBoxes = D / kCols;
  static constexpr uint64_t kLayout = kSw == 128 ? 1 : 2;  // descriptor
  __host__ __device__ static constexpr int bytes(int rows) {
    return rows * D * 2;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
// makes the initialised barriers visible to the other threads and to
// the async proxy (TMA); a __syncthreads() follows
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// one arrival that also expects `bytes` of transactions (TMA loads)
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// waits until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// ------------------------------------------------------------- TMA

// box at coordinates (column, h, t, b) of a 4-D map into dst, completing
// on bar
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}
// rows r0 .. r0 + rows - 1 of (b, h) into the tile at dst: one box each
// kCols columns; the map's box is kCols x rows
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, int rows,
                                         const CUtensorMap* map,
                                         uint64_t* bar, int b, int h,
                                         int r0) {
  using S = SwTile<D>;
#pragma unroll
  for (int c = 0; c < S::kBoxes; ++c)
    tma_load_4d(dst + c * rows * S::kSw, map, bar, c * S::kCols, h, r0, b);
}

// ----------------------------------------------------------- wgmma

// shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout in bits 62-63
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo,
                                              uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}
// K-major operand: rows r0 .. of a `rows`-row tile, k16 step kk of D
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int r0,
                                           int kk) {
  using S = SwTile<D>;
  const int col = kk * 16;
  return smem_desc(tile + (col / S::kCols) * rows * S::kSw + r0 * S::kSw +
                       (col % S::kCols) * 2,
                   16, 8 * S::kSw, S::kLayout);
}
// MN-major operand: the k16 step j over the tile's rows, N = D
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int j) {
  using S = SwTile<D>;
  return smem_desc(tile + j * 16 * S::kSw, rows * S::kSw, 8 * S::kSw,
                   S::kLayout);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of accumulator
// registers across the asynchronous products
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a b over k16: a from shared memory (K-major), b K-major
// (TransB 0) or MN-major (TransB 1); scale_d 0 overwrites d.  And the
// same with a from registers.
// m64n32k16: 16 f32 accumulators a thread
template <int TransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TransB));
}
template <int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TransB));
}
// m64n64k16: 32 f32 accumulators a thread
template <int TransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TransB));
}
template <int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TransB));
}
// m64n128k16: 64 f32 accumulators a thread
template <int TransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TransB));
}
template <int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TransB));
}

// 2^x on the special-function unit (what __expf runs after its multiply
// by log2(e)); 2^-inf = 0
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 values rounded to nearest even bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// the accumulator blocks 2 j and 2 j + 1 (columns 16 j .. 16 j + 15),
// rounded to bf16, as the A fragment of the k16 step j
template <int N>
__device__ __forceinline__ void acc_a16(const float (&d)[N], int j,
                                        uint32_t (&a)[4]) {
  a[0] = pack_bf16(d[8 * j], d[8 * j + 1]);
  a[1] = pack_bf16(d[8 * j + 2], d[8 * j + 3]);
  a[2] = pack_bf16(d[8 * j + 4], d[8 * j + 5]);
  a[3] = pack_bf16(d[8 * j + 6], d[8 * j + 7]);
}

// ------------------------------------------------------------ host

// error codes of the tensor-map setup, beside the CUDA runtime's
constexpr int kErrNoEncode = 9000;  // no cuTensorMapEncodeTiled
constexpr int kErrTensorMap = 9001;  // the driver refused a tensor map

const char* hopper_error_string(int err) {
  if (err == kErrNoEncode)
    return "the driver offers no cuTensorMapEncodeTiled (needs CUDA 12)";
  if (err == kErrTensorMap)
    return "cuTensorMapEncodeTiled refused a [B, T, H, D] tensor map";
  return nullptr;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled (its CUDA 12.0 signature), found
// once through the runtime, whose entry-point query changed in 12.5
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

// makes the current device's primary context current on this thread:
// the driver's encoder needs one, and a thread whose runtime calls so far
// needed none (an autograd worker thread, after the kernel's one-time
// configuration was done on another) may have none
cudaError_t bind_context() {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  return e != cudaSuccess ? e : cudaSetDevice(dev);
}

// the 4-D map (D, H, T, B) of a [B, T, H, D] bf16 tensor at `base` with
// element strides sb, st, sh (and 1 over D), boxes of kCols columns x
// `rows` rows of one (b, h), swizzled as SwTile<D>; rows past T read 0.
// Needs base and strides on 16 bytes.
template <int D>
int encode_rows(CUtensorMap* map, const void* base, long long sb,
                long long st, long long sh, int batch, int t_len,
                int heads, int rows) {
  using S = SwTile<D>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncode;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)t_len, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)S::kCols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      S::kSw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

}  // namespace

// Phase stamps of the consumer warps' loops, for tools/torch_flash_tune.py
// --cycles; empty unless FLASH_CYCLES is defined.  CYCLES_BEGIN starts a
// warp's clock, CYCLES_STAMP(i) adds the cycles since the last stamp to
// phase i (0 .. 5), CYCLES_END(k, warp) stamps phase 6 and writes the 7
// phases and a 1 to [block][warp][8] of buffer k of set_cycles (while a
// buffer is set).
#ifdef FLASH_CYCLES
__device__ unsigned long long* g_cycles[2];
#define CYCLES_BEGIN                    \
  unsigned long long cyc_[7] = {};      \
  unsigned long long cyc_t_ = clock64()
#define CYCLES_STAMP(i)                                 \
  do {                                                  \
    if ((threadIdx.x & 31) == 0 && g_cycles[0]) {       \
      const unsigned long long now_ = clock64();        \
      cyc_[i] += now_ - cyc_t_;                         \
      cyc_t_ = now_;                                    \
    }                                                   \
  } while (0)
#define CYCLES_END(k, warp)                                             \
  do {                                                                  \
    CYCLES_STAMP(6);                                                    \
    if ((threadIdx.x & 31) == 0 && g_cycles[0]) {                       \
      unsigned long long* o_ =                                          \
          g_cycles[k] + ((unsigned long long)blockIdx.x * 16 + (warp)) * 8; \
      for (int i_ = 0; i_ < 7; ++i_) o_[i_] = cyc_[i_];                 \
      o_[7] = 1;                                                        \
    }                                                                   \
  } while (0)
extern "C" int set_cycles(unsigned long long* a, unsigned long long* b) {
  unsigned long long* bufs[2] = {a, b};
  return (int)cudaMemcpyToSymbol(g_cycles, bufs, sizeof(bufs));
}
#else
#define CYCLES_BEGIN
#define CYCLES_STAMP(i)
#define CYCLES_END(k, warp)
#endif
