// int8 W8A8 matrix product with a fused dequantizing epilogue, for Hopper
// (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
//   unidisc_tpu/ops/int8_matmul.py:53  _kernel  (int8_matmul, call :105)
//
//   out[m, n] = float(sum_k a[m, k] * w[n, k]) * s[m] * ws[n] (+ bias[n])
//
// a (M, K) int8 row-major (per-row quantized activations), w (N, K) int8
// with K contiguous (the port's weight layout: the "col" operand of the
// tensor-core product), s (M) and ws (N) fp32 scales, bias (N) fp32 or
// null; out (M, N) bf16 or fp32, written once. The int32 accumulator never
// leaves the registers.
//
// Numerics: the integer product is exact. The epilogue keeps the JAX
// oracle's order, ((acc * s) * ws) + bias, with round-to-nearest intrinsics
// so that nvcc cannot contract the multiply and the add into an FMA: the
// fp32 output is bit-exact against the plain version, and the bf16 output
// is its round-to-nearest-even cast.
//
// Design: a 128 x 128 output tile per block of 8 warps (2 x 4), each warp a
// 64 x 32 tile of mma.sync.m16n8k32 int8 products (4 x 4 per 32-deep step,
// 64 int32 accumulators a thread). K advances in 64-byte steps through two
// shared-memory buffers: the next step's tiles are read from global memory
// into registers while the tensor cores work on the current one, then
// stored to the other buffer, one barrier a step. Rows are padded to 80
// bytes, so the fragment loads (8 rows x 4 words a warp) hit 32 distinct
// banks. Edges in M and N are predicated (out-of-range rows load as zero
// and are not stored); K must be a multiple of 16, checked by the wrapper.
//
// Bound: at the main path's trunk shapes (M 6144 = 16 rows x 384 tokens,
// K 768 or 3072, N 768 to 3072) the products are 7.2 to 29 G int8 ops, 3.7
// to 14.7 us at 1,979 TOPS, against 15 to 45 MB of operands and bf16
// output, 4.4 to 13.4 us at 3.35 TB/s: bound by operations at N >= 2304,
// by bytes at N = 768 (attn_out). The head (M 2048, K 768, N 16384) is
// 51.5 G ops (26 us) against 81 MB (24 us).
//
// What this simple design leaves on the table: mma.sync reaches a fraction
// of what wgmma does; the global loads are synchronous (staged through
// registers, not cp.async or TMA); no persistent scheduling or split-K for
// small grids.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // output rows per block
constexpr int BN = 128;      // output columns per block
constexpr int BK = 64;       // K bytes per shared-memory step
constexpr int SROW = BK + 16;  // padded shared-memory row, in bytes
constexpr int THREADS = 256;   // 8 warps: 2 along M x 4 along N
constexpr int CHUNKS = BM * BK / 16 / THREADS;  // 16-byte loads a thread

struct Params {
  const int8_t* a;     // (M, K)
  const float* s;      // (M)
  const int8_t* w;     // (N, K)
  const float* ws;     // (N)
  const float* bias;   // (N) or nullptr
  void* out;           // (M, N)
  int M, N, K;
};

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store_out(void* out, long long idx, float v,
                                          bool bf16) {
  if (bf16) {
    static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(out)[idx] = v;
  }
}

__global__ void __launch_bounds__(THREADS)
int8_matmul_kernel(const Params p, const bool out_bf16) {
  __shared__ __align__(16) int8_t a_s[2][BM * SROW];
  __shared__ __align__(16) int8_t w_s[2][BN * SROW];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;  // 64-row half of the tile
  const int wn = warp & 3;   // 32-column quarter of the tile
  const int g = lane >> 2;   // mma groupID
  const int t = lane & 3;    // mma threadID_in_group
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // 16-byte chunk c of a tile: row c / 4, bytes (c % 4) * 16 .. + 15
  uint4 ra[CHUNKS], rw[CHUNKS];
  auto load_global = [&](int k0) {
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int c = tid + i * THREADS;
      const int r = c >> 2;
      const int k = k0 + (c & 3) * 16;
      const uint4 zero = make_uint4(0, 0, 0, 0);
      ra[i] = (m0 + r < p.M && k < p.K)
                  ? *reinterpret_cast<const uint4*>(
                        p.a + static_cast<long long>(m0 + r) * p.K + k)
                  : zero;
      rw[i] = (n0 + r < p.N && k < p.K)
                  ? *reinterpret_cast<const uint4*>(
                        p.w + static_cast<long long>(n0 + r) * p.K + k)
                  : zero;
    }
  };
  auto store_shared = [&](int buf) {
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int c = tid + i * THREADS;
      const int off = (c >> 2) * SROW + (c & 3) * 16;
      *reinterpret_cast<uint4*>(&a_s[buf][off]) = ra[i];
      *reinterpret_cast<uint4*>(&w_s[buf][off]) = rw[i];
    }
  };

  const int nk = (p.K + BK - 1) / BK;
  load_global(0);
  store_shared(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load_global((kt + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        // A fragment: rows g and g + 8, bytes 4t..4t+3 and 16 + 4t..
        const int8_t* base =
            &a_s[buf][(wm * 64 + mi * 16 + g) * SROW + kk + t * 4];
        af[mi][0] = *reinterpret_cast<const uint32_t*>(base);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(base + 8 * SROW);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(base + 8 * SROW + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        // B fragment: column (weight row) g, k = 4t..4t+3 and 16 + 4t..
        const int8_t* base =
            &w_s[buf][(wn * 32 + ni * 8 + g) * SROW + kk + t * 4];
        bf[ni][0] = *reinterpret_cast<const uint32_t*>(base);
        bf[ni][1] = *reinterpret_cast<const uint32_t*>(base + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    if (kt + 1 < nk) store_shared(buf ^ 1);
    __syncthreads();
  }

  // epilogue: accumulator element e of tile (mi, ni) sits at row
  // g + 8 (e / 2), column 2t + (e % 2)
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 64 + mi * 16 + g + half * 8;
      if (row >= p.M) continue;
      const float sr = p.s[row];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn * 32 + ni * 8 + t * 2 + e;
          if (col >= p.N) continue;
          float v = __fmul_rn(
              __fmul_rn(__int2float_rn(acc[mi][ni][half * 2 + e]), sr),
              p.ws[col]);
          if (p.bias != nullptr) v = __fadd_rn(v, p.bias[col]);
          store_out(p.out, static_cast<long long>(row) * p.N + col, v,
                    out_bf16);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success). Shapes, dtypes, alignment and
// K % 16 == 0 are checked by the Python wrapper.
int int8_matmul(const void* a, const void* s, const void* w, const void* ws,
                const void* bias, void* out, int M, int N, int K,
                int out_bf16, void* stream) {
  Params p;
  p.a = static_cast<const int8_t*>(a);
  p.s = static_cast<const float*>(s);
  p.w = static_cast<const int8_t*>(w);
  p.ws = static_cast<const float*>(ws);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.M = M;
  p.N = N;
  p.K = K;
  if (M < 1 || N < 1 || K < 16 || K % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_matmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      p, out_bf16 != 0);
  return static_cast<int>(cudaGetLastError());
}

const char* int8_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
