// int8 W8A8 matrix product with a fused dequantizing epilogue, for Hopper
// (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
//   unidisc_tpu/ops/int8_matmul.py:53  _kernel  (int8_matmul, call :105)
//
//   out[m, n] = float(sum_k a[m, k] * w[n, k]) * s[m] * ws[n] (+ bias[n])
//
// a (M, K) int8 row-major (per-row quantized activations), w (N, K) int8
// with K contiguous (the port's weight layout), s (M) and ws (N) fp32
// scales, bias (N) fp32 or null; out (M, N) bf16 or fp32, written once.
// The int32 accumulator never leaves the registers.
//
// The raw form (out_kind 2) skips the epilogue and writes the int32
// accumulator itself, out (M, N) int32, reading no scale or bias. It is
// the row-parallel product of a tensor-parallel rank (models/dit.py): each
// rank's K-slice gives a partial sum, the int32 partials are summed over
// the group exactly, and the one epilogue runs on the sum. fp32 partials
// would not be exact: a rank's K-slice of mlp.2 at tensor 2 is 1,536
// deep, and 1,536 x 127^2 = 2.5e7 passes 2^24. It adds no replaced TPU
// kernel (JAX computes the whole row on every device, its int8 leaves
// replicated under "tensor"). Bound at the two row-parallel shapes of the
// flagship at tensor 2 (M 6144; K 384, N 768 and K 1536, N 768): 3.6 and
// 14.5 G int8 ops (1.8 and 7.3 us at 1,979 TOPS) against 21.5 and 29.5 MB
// of operands and int32 output (6.4 and 8.8 us at 3.35 TB/s): bytes.
//
// Numerics: the integer product is exact. The epilogue keeps the JAX
// oracle's order, ((acc * s) * ws) + bias, with round-to-nearest intrinsics
// so that nvcc cannot contract the multiply and the add into an FMA: the
// fp32 output is bit-exact against the plain version, and the bf16 output
// is its round-to-nearest-even cast.
//
// Design: a persistent grid (one block per SM, at most one per tile) walks
// output tiles of 128 rows x BLOCK_N columns, BLOCK_N 128, 192 or 256,
// chosen per shape by the wrapper (ops/int8_matmul.py, plan) against the
// wave quantization of the tiles over the SMs. At the int8 serve path's
// products on 132 SMs: attn_qkv, attn_out, mlp_0 and mlp_2 run 192-wide
// tiles (576, 192, 768 and 192 tiles: 4.36, 1.45, 5.82 and 1.45 waves),
// the head 256-wide ones (1,024 tiles, 7.76 waves).
//   - The last warp is the producer: its lane 0 streams, for each of the
//     block's tiles in turn, 128-byte slices of K of the A rows and of the
//     W rows through a ring of STAGES shared-memory stages with TMA
//     (rank-2 (K, rows) tensor maps, 128-byte swizzle, zeros out of range:
//     the M and N edges and the K tail past a multiple of 128), with a full
//     and an empty mbarrier per stage. The ring runs on across tiles, so
//     the next tile's loads overlap this tile's epilogue.
//   - Two consumer warpgroups own 64 rows of the tile each and run
//     wgmma m64nBLOCK_Nk32 s8 x s8 -> s32 with both operands K-major in
//     shared memory, as stored (wgmma takes 8-bit operands K-major only); a
//     k32 step is 32 bytes into the swizzled row, the descriptor arithmetic
//     of bf16's k16. One stage's four products are committed as a group
//     and the stage before it is released once its group is done, so the
//     tensor cores always have the next group queued.
//   - The epilogue scales the s32 accumulator (the fp32 accumulator's
//     layout) in registers. The tile's column scales and bias are loaded
//     before its products and parked in shared memory, and each warp
//     stages 128 bytes of each of its 16 rows at a time in shared memory,
//     so that its stores are whole 16-byte pieces of whole rows. Loaded
//     where it is used, each column's scale costs an L2 round trip (the
//     live accumulator leaves no registers to load ahead), and the
//     accumulator's fragments stored directly write 4 bytes of each of 8
//     rows a store: the epilogue then took several times the products.
//
// Registers: the accumulator is BLOCK_N / 2 a thread; the 9 warps cap a
// thread at 168. ptxas -v (nvcc 12.9): 127, 150 and 168 registers at
// BLOCK_N 128, 192 and 256, 0 bytes spill. Shared memory: 6, 4 or 4
// stages of 16 KB + BLOCK_N x 128 bytes, 18 KB of staging and the scales:
// 214-220 KB.
//
// Bound: at the main path's trunk shapes (M 6144 = 16 rows x 384 tokens,
// K 768 or 3072, N 768 to 3072) the products are 7.2 to 29 G int8 ops, 3.7
// to 14.7 us at 1,979 TOPS, against 15 to 45 MB of operands and bf16
// output, 4.4 to 13.4 us at 3.35 TB/s: bound by operations at N >= 2304,
// by bytes at N = 768 (attn_out). The head (M 2048, K 768, N 16384) is
// 51.5 G ops (26 us) against 81 MB (24 us).
//
// What the design does about the first version (mma.sync m16n8k32, loads
// staged through registers, one barrier a 64-byte step, one block per
// tile): wgmma at up to 64 x 256 a warpgroup, TMA loads with no thread
// spending an instruction on an address, no __syncthreads in the loop,
// a persistent grid whose tile width is chosen per shape, and whole-row
// stores.
//
// Phase trace (-DATTN_TRACE, read by scripts/int8_kernel_times.py
// --trace): thread 0 writes %globaltimer into slot 0 at the start, for the
// block's tile n < 7 into 8 n + 1 its start, 8 n + 2 its first stage
// landed, 8 n + 3 its last stage landed, 8 n + 4 its products done and
// 8 n + 7 its epilogue done; the producer into 8 n + 5 and 8 n + 6 the
// issue of the tile's first and last stage; 62 the end.

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BLOCK_M = 128;  // output rows per tile (two warpgroups of 64)
constexpr int BLOCK_K = 128;  // K bytes per stage: one 128-byte box row
constexpr int CONSUMERS = 2;
constexpr int THREADS = CONSUMERS * 128 + 32;
// a consumer warp stages 128 bytes of each of its 16 output rows at a
// time, each padded by 16 bytes against bank conflicts
constexpr int EPI_ROW = 128 + 16;

struct Params {
  const float* s;      // (M)
  const float* ws;     // (N)
  const float* bias;   // (N) or nullptr
  void* out;           // (M, N)
  int M, N, K;
  int out_kind;        // OUT_FP32, OUT_BF16 or OUT_INT32
};

enum OutKind { OUT_FP32 = 0, OUT_BF16 = 1, OUT_INT32 = 2 };

template <int BN>
struct Config {
  static constexpr int A_BYTES = BLOCK_M * BLOCK_K;  // 16 KB
  static constexpr int B_BYTES = BN * BLOCK_K;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // each consumer warp's staging area (EPI_ROW), and each warpgroup's
  // copy of the tile's column scales and bias
  static constexpr int EPI_BYTES = CONSUMERS * 4 * 16 * EPI_ROW;
  static constexpr int COLS_BYTES = CONSUMERS * 2 * BN * 4;
  static constexpr int STAGES =  // 6, 4 or 4
      (220 * 1024 - EPI_BYTES - COLS_BYTES) / STAGE_BYTES;
  static constexpr int OFF_B = STAGES * A_BYTES;
  static constexpr int OFF_EPI = OFF_B + STAGES * B_BYTES;
  static constexpr int OFF_COLS = OFF_EPI + EPI_BYTES;
  static constexpr int OFF_BAR = OFF_COLS + COLS_BYTES;
  static constexpr int SMEM = OFF_BAR + 2 * STAGES * 8 + 1024;
};

template <int BN>
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[BN / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (BN == 128) {
    wgmma_s8_64x128(d, da, db, accumulate);
  } else if constexpr (BN == 192) {
    wgmma_s8_64x192(d, da, db, accumulate);
  } else {
    wgmma_s8_64x256(d, da, db, accumulate);
  }
}

// The epilogue of one consumer warp: its 16 rows (row0 .. row0 + 15 of
// the output, the fragment rows g and g + 8 of this thread) x BN columns
// from n0, scaled in the JAX oracle's order. 128 bytes of each row at a
// time (64 bf16 or 32 fp32 columns) go through the warp's staging area, so
// that the stores to `out` are whole 16-byte pieces of whole rows: each
// store instruction of the warp writes four 128-byte row segments. Pieces
// at the edges (or all of them, where a row of `out` is not a multiple of
// 16 bytes) are stored element by element.
// With T int32_t the accumulator goes out as it is (the raw form).
template <typename T, int BN>
__device__ __forceinline__ void store_tile(const Params& p,
                                           const int32_t (&acc)[BN / 2],
                                           unsigned char* stage, int row0,
                                           int n0, const float* sWs,
                                           const float* sBias, int lane) {
  constexpr int CH = 128 / sizeof(T);  // columns of one 128-byte segment
  constexpr bool RAW = std::is_same<T, int32_t>::value;
  const int g = lane >> 2, t = lane & 3;
  float s0 = 0.f, s1 = 0.f;
  if constexpr (!RAW) {
    s0 = row0 + g < p.M ? __ldg(p.s + row0 + g) : 0.f;
    s1 = row0 + g + 8 < p.M ? __ldg(p.s + row0 + g + 8) : 0.f;
  }
  const bool bias = p.bias != nullptr;
  const bool vec = (static_cast<long long>(p.N) * sizeof(T)) % 16 == 0;
#pragma unroll
  for (int c = 0; c < BN / CH; ++c) {
    // this thread's values of the segment into the staging area
#pragma unroll
    for (int jj = 0; jj < CH / 8; ++jj) {
      const int j = c * (CH / 8) + jj;
      const int cl = 8 * j + 2 * t;  // column within the tile
      float v[4];
      if constexpr (!RAW) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[e] = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + e]),
                                     e < 2 ? s0 : s1),
                           sWs[cl + e % 2]);
          if (bias) v[e] = __fadd_rn(v[e], sBias[cl + e % 2]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        unsigned char* at = stage + (g + 8 * r) * EPI_ROW +
                            (8 * jj + 2 * t) * sizeof(T);
        if constexpr (RAW) {
          *reinterpret_cast<int2*>(at) =
              make_int2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
        } else if constexpr (sizeof(T) == 2) {
          *reinterpret_cast<__nv_bfloat162*>(at) =
              __floats2bfloat162_rn(v[2 * r], v[2 * r + 1]);
        } else {
          *reinterpret_cast<float2*>(at) = make_float2(v[2 * r], v[2 * r + 1]);
        }
      }
    }
    __syncwarp();
    // the segment's 16 rows x 8 pieces of 16 bytes, four rows a store
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int r = 4 * it + (lane >> 3);
      const int piece = lane & 7;
      const int row = row0 + r;
      const int col = n0 + c * CH + piece * (16 / sizeof(T));
      const unsigned char* from =
          stage + r * EPI_ROW + piece * 16;
      T* to = static_cast<T*>(p.out) + static_cast<long long>(row) * p.N + col;
      if (row < p.M) {
        if (vec && col + 16 / static_cast<int>(sizeof(T)) <= p.N) {
          *reinterpret_cast<uint4*>(to) =
              *reinterpret_cast<const uint4*>(from);
        } else {
          const T* vals = reinterpret_cast<const T*>(from);
#pragma unroll
          for (int e = 0; e < 16 / static_cast<int>(sizeof(T)); ++e) {
            if (col + e < p.N) to[e] = vals[e];
          }
        }
      }
    }
    __syncwarp();
  }
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
    int8_matmul_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_w,
                       const Params p) {
  using C = Config<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sA = smem;
  unsigned char* sB = smem + C::OFF_B;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* empty = full + C::STAGES;

  // tiles in order of M first, so that the blocks in flight share W tiles
  const int m_tiles = (p.M + BLOCK_M - 1) / BLOCK_M;
  const int tiles = m_tiles * ((p.N + BN - 1) / BN);
  const int nk = (p.K + BLOCK_K - 1) / BLOCK_K;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);                // the TMA's expect_tx arrival
      mbar_init(&empty[s], CONSUMERS * 4);   // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS * 128) {
    // ---- producer: lane 0 of the last warp ----
    if (tid == CONSUMERS * 128) {
      int it = 0, nt = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++nt) {
        const int m0 = (tile % m_tiles) * BLOCK_M;
        const int n0 = (tile / m_tiles) * BN;
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int stage = it % C::STAGES;
          mbar_wait(&empty[stage], ((it / C::STAGES) & 1) ^ 1);
          TRACE_IF(nt < 7 && kb == 0, 8 * nt + 5);
          TRACE_IF(nt < 7 && kb == nk - 1, 8 * nt + 6);
          mbar_arrive_expect_tx(&full[stage], C::STAGE_BYTES);
          tma_load_2d(sA + stage * C::A_BYTES, &map_a, &full[stage],
                      kb * BLOCK_K, m0);
          tma_load_2d(sB + stage * C::B_BYTES, &map_w, &full[stage],
                      kb * BLOCK_K, n0);
        }
      }
    }
  } else {
    // ---- consumer warpgroups ----
    const int wg = tid / 128;
    const int warp = (tid % 128) / 32;
    const int lane = tid & 31;
    const int lt = tid % 128;  // thread within the warpgroup
    float* sWs = reinterpret_cast<float*>(smem + C::OFF_COLS) + wg * 2 * BN;
    float* sBias = sWs + BN;
    unsigned char* stage_epi = smem + C::OFF_EPI +
                               (wg * 4 + warp) * 16 * EPI_ROW;
    int32_t acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

    auto release = [&](int stage) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
    };
    // every thread of this warpgroup (named barrier 1 + wg; 0 is the
    // block's)
    auto wg_sync = [&]() {
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    };

    int it = 0, nt = 0;
    TRACE_IF(tid == 0, 0);
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++nt) {
      const int m0 = (tile % m_tiles) * BLOCK_M;
      const int n0 = (tile / m_tiles) * BN;
      TRACE_IF(tid == 0 && nt < 7, 8 * nt + 1);
      // the tile's column scales and bias: loaded now, used after the
      // products, so their latency hides behind them
      constexpr int PER = (BN + 127) / 128;
      float wv[PER], bv[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int c = n0 + lt + 128 * i;
        const bool in = lt + 128 * i < BN && c < p.N;
        wv[i] = in && p.ws != nullptr ? __ldg(p.ws + c) : 0.f;
        bv[i] = in && p.bias != nullptr ? __ldg(p.bias + c) : 0.f;
      }
      for (int kb = 0; kb < nk; ++kb, ++it) {
        const int stage = it % C::STAGES;
        const unsigned char* tA = sA + stage * C::A_BYTES;
        const unsigned char* tB = sB + stage * C::B_BYTES;
        mbar_wait(&full[stage], (it / C::STAGES) & 1);
        TRACE_IF(tid == 0 && nt < 7 && kb == 0, 8 * nt + 2);
        TRACE_IF(tid == 0 && nt < 7 && kb == nk - 1, 8 * nt + 3);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BLOCK_K / 32; ++ks) {
          wgmma_s8<BN>(acc, desc_kmajor(tA, BLOCK_M, wg * 64, ks),
                       desc_kmajor(tB, BN, 0, ks), kb > 0 || ks > 0);
        }
        wgmma_commit();
        // the previous stage's products are done: release it
        wgmma_wait<1>();
        if (kb > 0) release((it - 1) % C::STAGES);
      }
      wgmma_wait0();
      fence_acc(acc);
      release((it - 1) % C::STAGES);
      TRACE_IF(tid == 0 && nt < 7, 8 * nt + 4);

      wg_sync();  // the previous tile's epilogue is done with sWs, sBias
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        if (lt + 128 * i < BN) {
          sWs[lt + 128 * i] = wv[i];
          sBias[lt + 128 * i] = bv[i];
        }
      }
      wg_sync();
      const int row0 = m0 + wg * 64 + warp * 16;
      if (p.out_kind == OUT_BF16) {
        store_tile<__nv_bfloat16, BN>(p, acc, stage_epi, row0, n0, sWs,
                                      sBias, lane);
      } else if (p.out_kind == OUT_INT32) {
        store_tile<int32_t, BN>(p, acc, stage_epi, row0, n0, sWs, sBias,
                                lane);
      } else {
        store_tile<float, BN>(p, acc, stage_epi, row0, n0, sWs, sBias,
                              lane);
      }
      TRACE_IF(tid == 0 && nt < 7, 8 * nt + 7);
    }
    TRACE_IF(tid == 0, 62);
  }
}

// Encode the two tensor maps and launch `grid` blocks on `stream`.
template <int BN>
cudaError_t launch(const void* a, const void* w, int grid, const Params& p,
                   cudaStream_t stream) {
  using C = Config<BN>;
  CUtensorMap ma, mw;
  cudaError_t err = encode_rows_s8(&ma, a, p.M, p.K, BLOCK_M);
  if (err == cudaSuccess) err = encode_rows_s8(&mw, w, p.N, p.K, BN);
  if (err != cudaSuccess) return err;
  static unsigned long long smem_set = 0;
  err = set_smem_once(int8_matmul_kernel<BN>, C::SMEM, &smem_set);
  if (err != cudaSuccess) return err;
  int8_matmul_kernel<BN><<<grid, THREADS, C::SMEM, stream>>>(ma, mw, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success). Shapes, dtypes, alignment and
// K % 16 == 0 are checked by the Python wrapper, which also chooses
// block_n (128, 192 or 256) and the persistent grid (at most one block per
// tile). out_kind: 0 fp32, 1 bf16 (the epilogue), 2 int32 (the raw
// accumulator; s, ws and bias are not read and may be null).
int int8_matmul(const void* a, const void* s, const void* w, const void* ws,
                const void* bias, void* out, int M, int N, int K, int block_n,
                int grid, int out_kind, void* stream) {
  if (M < 1 || N < 1 || K < 16 || K % 16 != 0 || grid < 1 ||
      out_kind < OUT_FP32 || out_kind > OUT_INT32 ||
      (out_kind != OUT_INT32 && (s == nullptr || ws == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.s = static_cast<const float*>(s);
  p.ws = static_cast<const float*>(ws);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.M = M;
  p.N = N;
  p.K = K;
  p.out_kind = out_kind;
  if (out_kind == OUT_INT32) p.bias = nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (block_n) {
    case 128: return static_cast<int>(launch<128>(a, w, grid, p, st));
    case 192: return static_cast<int>(launch<192>(a, w, grid, p, st));
    case 256: return static_cast<int>(launch<256>(a, w, grid, p, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* int8_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
