// Hopper (sm_90a) building blocks shared by the kernels that run on TMA,
// mbarriers and wgmma (flash_fwd.cu, flash_bwd_dq.cu, flash_bwd_dkv.cu,
// int8_matmul.cu): inline PTX only, so a source that includes this header
// builds in seconds.
//
// Shared-memory tiles are 128-byte-swizzled boxes written by TMA: a box of
// R rows x 64 bf16 (or 128 int8) columns is R rows of 128 bytes, the 16-byte
// chunks of row r XOR-ed with r % 8, and it starts on a 1024-byte boundary.
// A head_dim of 128 is two such boxes side by side (columns 0-63, then
// 64-127).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int BOX_COLS = 64;                 // bf16 columns of one box
constexpr int ROW_BYTES = BOX_COLS * 2;      // 128
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the barrier has completed the phase of the given parity. A
// wait that has not returned after 2^26 polls means a broken pipeline: trap,
// so the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) asm volatile("trap;\n");
  }
}

// Copy 4 bytes from global to shared memory asynchronously; with
// `valid` false nothing is read and the destination is zeroed.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Arrive on `bar` once this thread's earlier cp.async copies have landed
// (the barrier's expected count includes this arrival).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// ---- TMA --------------------------------------------------------------------

// Copy the box at element coordinates (c0 column, c1 head, c2 row, c3 batch)
// of a rank-4 (D, H, L, B) tensor map into shared memory; completion is
// counted on `bar` in bytes. Rows at or past L (and any coordinate out of
// range) read as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_"
      "tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// All D / 64 column boxes of the rows [row0, row0 + rows) of head h of
// batch b; box k lands at dst + k * rows * 128 bytes.
template <int D>
__device__ __forceinline__ void tma_load_rows(void* dst, const CUtensorMap* map,
                                              uint64_t* bar, int rows, int h,
                                              int row0, int b) {
#pragma unroll
  for (int k = 0; k < D / BOX_COLS; ++k) {
    tma_load_4d(static_cast<char*>(dst) + k * rows * ROW_BYTES, map, bar,
                k * BOX_COLS, h, row0, b);
  }
}

// Copy the box at element coordinates (c0 column, c1 row) of a rank-2 tensor
// map into shared memory; completion is counted on `bar` in bytes.
// Coordinates out of range read as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_"
      "tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// ---- wgmma ------------------------------------------------------------------

// Shared-memory matrix descriptor with 128-byte swizzle. lbo and sbo are in
// bytes. A K-major operand (rows of 128 bytes along K) uses sbo = 1024, the
// step from one 8-row group to the next; lbo is not read. An MN-major operand
// of N = 64 (one 128-byte atom along N) uses sbo = 1024 too, the step from
// one group of 8 K-rows to the next; lbo, the step between 64-wide N atoms,
// is not read at N = 64 either, and is set to 1024 as well.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = (smem_u32(p) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= 1ull << 62;  // 128-byte swizzle
  return d;
}

// K-major operand of 64 rows (or any multiple of 8) stored as D / 64 boxes of
// `rows` rows: descriptor of k-step ks (16 columns) for the rows starting at
// `row0` (a multiple of 8).
__device__ __forceinline__ uint64_t desc_kmajor(const void* tile, int rows,
                                                int row0, int ks) {
  const char* p = static_cast<const char*>(tile) +
                  (ks / 4) * rows * ROW_BYTES + row0 * ROW_BYTES +
                  (ks % 4) * 32;
  return desc_sw128(p, 16, 1024);
}

// MN-major B operand (K rows, N columns contiguous) stored as boxes of
// `rows` K-rows: descriptor of the 64-column box `nb` at k-step ks (K-rows
// 16 ks .. 16 ks + 15).
__device__ __forceinline__ uint64_t desc_mnmajor(const void* tile, int rows,
                                                 int nb, int ks) {
  const char* p = static_cast<const char*>(tile) + nb * rows * ROW_BYTES +
                  ks * 16 * ROW_BYTES;
  return desc_sw128(p, 1024, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(int32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define HOPPER_D32(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])

#define HOPPER_D32_LIST                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"

// d (64 x 64 fp32) (+)= A (64 x 16, shared, K-major) * B (16 x 64, shared;
// K-major, or MN-major when TRANS_B). The fp32 accumulator of thread
// (warp w, lane l) holds rows 16 w + l / 4 (+ 8) and columns
// 8 j + 2 (l % 4) (+ 1): d[4 j + e] is (row + 8 (e / 2), col + e % 2).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_64x64(float (&d)[32], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32_LIST
      ", %32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : HOPPER_D32(d)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
}

// d (64 x 64 fp32) (+)= A (64 x 16 bf16 in registers, the m16n8k16 A
// fragment of each warp's 16 rows) * B (16 x 64, shared; MN-major when
// TRANS_B).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_64x64(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : HOPPER_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
        "n"(TRANS_B));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&p);
}

// The A fragment of k-step kk (columns 16 kk .. 16 kk + 15) of a 64 x 64
// fp32 accumulator, rounded to bf16: the accumulator of columns 8 j .. 8 j
// + 7 is exactly the A fragment's half for those columns.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&d)[32],
                                         int kk) {
  a[0] = pack_bf16x2(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16x2(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16x2(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16x2(d[8 * kk + 6], d[8 * kk + 7]);
}

// int8 products: d (64 x N s32) (+)= A (64 x 32 s8, shared, K-major) *
// B (32 x N s8, shared, K-major: N rows of 32 bytes along K), N 128, 192 or
// 256. wgmma takes 8-bit operands K-major only. The s32 accumulator has the
// fp32 one's layout: d[4 j + e] is (row 16 w + l / 4 + 8 (e / 2), column
// 8 j + 2 (l % 4) + e % 2) for thread (warp w, lane l).
#define HOPPER_R8(i)                                                          \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define HOPPER_R32(i) \
  HOPPER_R8(i), HOPPER_R8(i + 8), HOPPER_R8(i + 16), HOPPER_R8(i + 24)
#define HOPPER_S8_LIST128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, " \
  "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, " \
  "%61, %62, %63}"
#define HOPPER_S8_LIST192 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, " \
  "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, " \
  "%61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, " \
  "%76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, " \
  "%91, %92, %93, %94, %95}"
#define HOPPER_S8_LIST256 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, " \
  "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, " \
  "%61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, " \
  "%76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, " \
  "%91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, " \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, " \
  "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"
#define HOPPER_WGMMA_S8(N, DA, DB, ACC, ...)                                  \
  __device__ __forceinline__ void wgmma_s8_64x##N(                            \
      int32_t(&d)[N / 2], uint64_t da, uint64_t db, int accumulate) {         \
    asm volatile(                                                             \
        "{\n"                                                                 \
        ".reg .pred p;\n"                                                     \
        "setp.ne.b32 p, " ACC ", 0;\n"                                        \
        "wgmma.mma_async.sync.aligned.m64n" #N "k32.s32.s8.s8 "               \
        HOPPER_S8_LIST##N ", " DA ", " DB ", p;\n"                             \
        "}\n"                                                                 \
        : __VA_ARGS__                                                         \
        : "l"(da), "l"(db), "r"(accumulate));                                 \
  }
HOPPER_WGMMA_S8(128, "%64", "%65", "%66", HOPPER_R32(0), HOPPER_R32(32))
HOPPER_WGMMA_S8(192, "%96", "%97", "%98", HOPPER_R32(0), HOPPER_R32(32),
                HOPPER_R32(64))
HOPPER_WGMMA_S8(256, "%128", "%129", "%130", HOPPER_R32(0), HOPPER_R32(32),
                HOPPER_R32(64), HOPPER_R32(96))
#undef HOPPER_WGMMA_S8
#undef HOPPER_S8_LIST128
#undef HOPPER_S8_LIST192
#undef HOPPER_S8_LIST256
#undef HOPPER_R32
#undef HOPPER_R8

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- host side --------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library links against nothing but the runtime.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p)
                                            : nullptr;
  }();
  return fn;
}

// Rank-4 tensor map over a (B, L, H, D) bf16 tensor seen as (D, H, L, B),
// element strides (sb, sl, sh) of batch, row and head; boxes of 64 columns x
// 1 head x `box_rows` rows x 1 batch, 128-byte swizzle, zeros out of range.
// The stride of a dimension of size 1 is never followed and is replaced by
// one TMA accepts.
inline cudaError_t encode_bhld(CUtensorMap* map, const void* base, int B,
                               int L, int H, int D, long long sb, long long sl,
                               long long sh, int box_rows) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const long long row = static_cast<long long>(D) * 2;
  auto bytes = [&](long long s, int n) {
    return static_cast<cuuint64_t>(n == 1 ? row : s * 2);
  };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {bytes(sh, H), bytes(sl, L), bytes(sb, B)};
  const cuuint32_t box[4] = {BOX_COLS, 1, static_cast<cuuint32_t>(box_rows),
                             1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Rank-2 tensor map over a (rows, K) int8 matrix with contiguous rows of K
// bytes (K a multiple of 16, as TMA's strides must be): boxes of 128 bytes
// of K x `box_rows` rows, 128-byte swizzle, zeros out of range.
inline cudaError_t encode_rows_s8(CUtensorMap* map, const void* base, int rows,
                                  int K, int box_rows) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {ROW_BYTES, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Set a kernel's dynamic shared-memory limit once per device, not on every
// launch.
template <typename Kernel>
cudaError_t set_smem_once(Kernel kernel, int bytes, unsigned long long* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (__atomic_load_n(done, __ATOMIC_ACQUIRE) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) __atomic_fetch_or(done, bit, __ATOMIC_RELEASE);
  return err;
}

}  // namespace hopper

// Phase trace, compiled only with -DATTN_TRACE (scripts/attention_phase_trace.py
// builds and reads it): thread 0 of the first consumer warpgroup, and lane 0
// of the producer, write %globaltimer (ns) into 64 slots per block of the
// buffer set by attn_trace_set: 0 start; 1 first tile of the block's own
// operand (Q; Q, dO and O; or K and V) landed; 39 di formed (dq); for KV /
// query tile k < 6, at 2 + 6 k: its data landed, first products done,
// elementwise done, second products issued, second products done, stage
// released; 40 + k the producer's TMA issue of tile k, 46 + k its
// empty-wait passed (dq, dkv); 62 end.
#ifdef ATTN_TRACE
__device__ unsigned long long* g_trace;
extern "C" int attn_trace_set(void* p) {
  return (int)cudaMemcpyToSymbol(g_trace, &p, sizeof(p));
}
#define TRACE_IF(cond, slot)                                                  \
  do {                                                                        \
    if (g_trace && (cond)) {                                                  \
      unsigned long long t_;                                                  \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                  \
      g_trace[((unsigned long long)blockIdx.y * gridDim.x + blockIdx.x) * 64 + \
              (slot)] = t_;                                                   \
    }                                                                         \
  } while (0)
#else
#define TRACE_IF(cond, slot)
#endif
