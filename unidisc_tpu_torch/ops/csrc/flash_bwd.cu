// Attention backward, dQ, for Hopper (sm_90a): bf16 in and out, fp32
// accumulation.
//
// Replaces the JAX package's Pallas TPU kernel
//   unidisc_tpu/ops/pallas_attention.py:449  _bwd_dq_kernel   (dQ)
// in the FlashAttention-2 split of the backward; its partner, the port of
//   unidisc_tpu/ops/pallas_attention.py:402  _bwd_dkv_kernel  (dK, dV)
// is flash_bwd_dkv.cu, launched after this one on the same stream.
//   flash_bwd_dq_kernel: one block per (batch * head, 64-row query tile),
//     looping over KV tiles. It first computes di = rowsum(O * dO) for its
//     rows (JAX computes di outside its kernels, pallas_attention.py:494)
//     and writes it to a (B, H, Lq) fp32 buffer, which the dkv kernel
//     reads, then accumulates dQ = sum_kv dS K.
// No atomics, so the result is deterministic.
//
// Semantics (identical to _masked_p and the TPU kernel):
//   S = Q K^T * scale in fp32 from bf16 products; masked (query, key) pairs
//   (causal: key > query; segments: qseg != kseg or qseg < 0) get an
//   additive -1e30; P = exp(S - LSE) with the forward's LSE; a row with no
//   allowed key has LSE 0, so its P and dQ are 0. dP = dO V^T;
//   dS = P * (dP - di) * scale; dQ = dS K. Keys at or past Lk contribute
//   nothing. dS is rounded to bf16 as the A operand of dS K (the JAX kernel
//   keeps it in fp32).
//
// Layout: q, k, v, o, dO, dq are (B, L, H, D) with any batch, row and head
// strides (in elements, multiples of 8) and a contiguous last dimension, so
// the kernel reads the DIT's projection views with no transposes. LSE and
// di are (B, H, Lq) fp32; segment ids (B, Lq) and (B, Lk) int32.
//
// Design: 4 warps per block, each warp owns 16 query rows of the block's
// tile. The block's Q and dO tiles and the K/V tiles of the inner loop are
// staged in shared memory (rows padded by 8 elements) and the A fragments
// are read from there at each use, which keeps registers for the fp32
// accumulator. Products use mma.sync m16n8k16 bf16 -> fp32; the fp32 score
// fragments are repacked in registers into the A operand of the next
// product. Causal tiles that hold no allowed pair are skipped.
//
// Bound at the train path's shape (B 32, H 12, L 384, D 64): q, k, v, o,
// dO, dq are 113 MB and LSE, di 1.2 MB, 34 us at 3.35 TB/s; the three
// products are 6 D FLOPs per (query, key) pair, 22 GFLOP, 22 us at 989
// TFLOP/s: bound by bytes.
//
// What this simple design leaves on the table: loads are synchronous (no
// cp.async or TMA pipelining), mma.sync reaches a fraction of wgmma, the
// transposed B operand K is gathered with 16-bit shared-memory loads
// instead of ldmatrix.trans, and S and dP are computed again here and in
// the dkv kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 64;     // rows of a tile (queries or keys)
constexpr int THREADS = 128;  // 4 warps x 16 rows
constexpr int PAD = 8;        // shared-memory row padding, in elements
constexpr float MASK_VALUE = -1e30f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;  // (B, H, Lq)
  float* di;         // (B, H, Lq): written by the dq kernel, read by dkv
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  const int* qseg;  // (B, Lq) or nullptr
  const int* kseg;  // (B, Lk) or nullptr (set iff qseg is)
  int H, Lq, Lk;
  // strides (batch, row, head) of q, k, v, o, dout, dq, dk, dv
  long long st[8][3];
  float scale;
  int causal;
};

enum { Q = 0, K = 1, V = 2, O = 3, DO = 4, DQ = 5, DK = 6, DV = 7 };

__device__ __forceinline__ uint32_t pack_floats(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// D (16x8, fp32) += A (16x16 bf16, row-major) * B (16x8 bf16, col-major)
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy rows [row0, row0 + 64) of a (L, D) slab with row stride `sl` into
// shared memory (row stride D + PAD); rows at or past L are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long sl, int row0, int L,
                                          int tid) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int idx = tid; idx < BLOCK * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS;
    const int c = idx % CHUNKS;
    const int gr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < L) {
      val = *reinterpret_cast<const uint4*>(src + gr * sl + c * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * (D + PAD) + c * 8) = val;
  }
}

// A fragment (16 rows from `row0`, columns kc*16 .. kc*16+15) of a
// row-major shared tile
template <int D>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4],
                                       const __nv_bfloat16* s, int row0,
                                       int kc, int g, int t) {
  const __nv_bfloat16* lo = s + (row0 + g) * (D + PAD) + kc * 16 + 2 * t;
  const __nv_bfloat16* hi = lo + 8 * (D + PAD);
  a[0] = *reinterpret_cast<const uint32_t*>(lo);
  a[1] = *reinterpret_cast<const uint32_t*>(hi);
  a[2] = *reinterpret_cast<const uint32_t*>(lo + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(hi + 8);
}

// acc (16 x 64) = A (16 rows of sa from row0, depth D) * B^T where B is the
// 64-row shared tile sb (depth D): the score-shaped product Q K^T, dO V^T,
// K Q^T or V dO^T.
template <int D>
__device__ __forceinline__ void rows_times_tile_t(float (&acc)[BLOCK / 8][4],
                                                  const __nv_bfloat16* sa,
                                                  int row0,
                                                  const __nv_bfloat16* sb,
                                                  int g, int t) {
  constexpr int LDS = D + PAD;
#pragma unroll
  for (int j = 0; j < BLOCK / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t a[4];
    a_frag<D>(a, sa, row0, kc, g, t);
#pragma unroll
    for (int j = 0; j < BLOCK / 8; ++j) {
      const __nv_bfloat16* br = sb + (j * 8 + g) * LDS + kc * 16 + 2 * t;
      mma_16816(acc[j], a, *reinterpret_cast<const uint32_t*>(br),
                *reinterpret_cast<const uint32_t*>(br + 8));
    }
  }
}

// acc (16 x D) += A (16 x 64, bf16 fragments packed from a score-shaped
// fp32 tile) * the 64-row shared tile sb (64 x D): dS K, P^T dO, dS^T Q.
template <int D>
__device__ __forceinline__ void score_times_tile(float (&acc)[D / 8][4],
                                                 const float (&x)[BLOCK / 8][4],
                                                 const __nv_bfloat16* sb,
                                                 int g, int t) {
  constexpr int LDS = D + PAD;
#pragma unroll
  for (int kk = 0; kk < BLOCK / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_floats(x[2 * kk][0], x[2 * kk][1]);
    a[1] = pack_floats(x[2 * kk][2], x[2 * kk][3]);
    a[2] = pack_floats(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = pack_floats(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const __nv_bfloat16* bc = sb + (kk * 16 + 2 * t) * LDS + n * 8 + g;
      const uint32_t b0 = pack_bf16(bc[0], bc[LDS]);
      const uint32_t b1 = pack_bf16(bc[8 * LDS], bc[9 * LDS]);
      mma_16816(acc[n], a, b0, b1);
    }
  }
}

// Write 16 rows x D of fp32 accumulators as bf16 rows of a (L, D) slab.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long sl,
                                           const int (&row)[2], int L,
                                           const float (&acc)[D / 8][4],
                                           int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= L) continue;
    __nv_bfloat16* dst = base + row[r] * sl + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          pack_floats(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const Params p) {
  constexpr int LDS = D + PAD;
  constexpr int NS = BLOCK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sDO = sQ + BLOCK * LDS;
  __nv_bfloat16* sK = sDO + BLOCK * LDS;
  __nv_bfloat16* sV = sK + BLOCK * LDS;
  int* sKseg = reinterpret_cast<int*>(sV + BLOCK * LDS);
  float* sDi = reinterpret_cast<float*>(sKseg + BLOCK);

  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  const int q0 = blockIdx.y * BLOCK;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long bh_row = (static_cast<long long>(b) * p.H + h) * p.Lq;

  load_tile<D>(sQ, p.q + b * p.st[Q][0] + h * p.st[Q][2], p.st[Q][1], q0,
               p.Lq, tid);
  load_tile<D>(sDO, p.dout + b * p.st[DO][0] + h * p.st[DO][2], p.st[DO][1],
               q0, p.Lq, tid);
  __syncthreads();

  // di = rowsum(O * dO) in fp32: each warp its own 16 rows, lanes over D
  const __nv_bfloat16* obase = p.o + b * p.st[O][0] + h * p.st[O][2];
  for (int r = 0; r < 16; ++r) {
    const int lr = warp * 16 + r;
    const int row = q0 + lr;
    float acc = 0.f;
    if (row < p.Lq) {
      for (int c = lane; c < D; c += 32) {
        acc += __bfloat162float(obase[row * p.st[O][1] + c]) *
               __bfloat162float(sDO[lr * LDS + c]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) {
      sDi[lr] = acc;
      if (row < p.Lq) p.di[bh_row + row] = acc;
    }
  }
  __syncwarp();

  const int r0 = warp * 16;  // this warp's first local row
  const int row[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  float lse[2], di[2];
  int qs[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row[r] < p.Lq;
    lse[r] = in ? p.lse[bh_row + row[r]] : 0.f;
    di[r] = sDi[r0 + g + 8 * r];
    if (p.qseg != nullptr) qs[r] = in ? p.qseg[b * p.Lq + row[r]] : -1;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }

  int n_tiles = (p.Lk + BLOCK - 1) / BLOCK;
  if (p.causal) {
    const int q_last = min(q0 + BLOCK, p.Lq) - 1;
    n_tiles = min(n_tiles, q_last / BLOCK + 1);
  }
  const __nv_bfloat16* kbase = p.k + b * p.st[K][0] + h * p.st[K][2];
  const __nv_bfloat16* vbase = p.v + b * p.st[V][0] + h * p.st[V][2];

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BLOCK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(sK, kbase, p.st[K][1], k0, p.Lk, tid);
    load_tile<D>(sV, vbase, p.st[V][1], k0, p.Lk, tid);
    if (p.kseg != nullptr && tid < BLOCK) {
      sKseg[tid] = k0 + tid < p.Lk ? p.kseg[b * p.Lk + k0 + tid] : -2;
    }
    __syncthreads();

    float s[NS][4], dp[NS][4];
    rows_times_tile_t<D>(s, sQ, r0, sK, g, t);    // S = Q K^T
    rows_times_tile_t<D>(dp, sDO, r0, sV, g, t);  // dP = dO V^T

    // P = exp(S * scale + mask - LSE); dS = P (dP - di) scale, into s
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int cl = j * 8 + 2 * t + (e & 1);
        const int col = k0 + cl;
        float pv = 0.f;
        if (col < p.Lk) {
          float val = s[j][e] * p.scale;
          bool ok = true;
          if (p.causal) ok = col <= row[r];
          if (p.qseg != nullptr) ok = ok && qs[r] == sKseg[cl] && qs[r] >= 0;
          if (!ok) val += MASK_VALUE;
          pv = expf(val - lse[r]);
        }
        s[j][e] = pv * (dp[j][e] - di[r]) * p.scale;
      }
    }
    score_times_tile<D>(acc, s, sK, g, t);  // dQ += dS K
  }

  store_rows<D>(p.dq + b * p.st[DQ][0] + h * p.st[DQ][2], p.st[DQ][1], row,
                p.Lq, acc, t);
}

template <int D>
int smem_bytes() {
  return 4 * BLOCK * (D + PAD) * static_cast<int>(sizeof(__nv_bfloat16)) +
         3 * BLOCK * 4;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, dim3 grid, const Params& p,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const void* lse, void* di, void* dq,
                   void* dk, void* dv, const void* qseg, const void* kseg,
                   int heads, int lq, int lk, const long long* strides,
                   float scale, int causal) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.di = static_cast<float*>(di);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.H = heads;
  p.Lq = lq;
  p.Lk = lk;
  for (int i = 0; i < 8; ++i) {
    for (int j = 0; j < 3; ++j) p.st[i][j] = strides[3 * i + j];
  }
  p.scale = scale;
  p.causal = causal;
  return p;
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success). Shapes, strides and types are
// checked by the Python wrapper; head_dim must be 64 or 128. `strides`
// holds (batch, row, head) strides, in elements, of q, k, v, o, dout, dq,
// dk, dv in that order. flash_bwd_dq_bf16 writes di and dq; it must run
// before flash_bwd_dkv_bf16 (flash_bwd_dkv.cu), which reads di.
int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const void* lse,
                      void* di, void* dq, const void* qseg, const void* kseg,
                      int batch, int heads, int lq, int lk, int head_dim,
                      const long long* strides, float scale, int causal,
                      void* stream) {
  const Params p = make_params(q, k, v, o, dout, lse, di, dq, nullptr,
                               nullptr, qseg, kseg, heads, lq, lk, strides,
                               scale, causal);
  const dim3 grid(batch * heads, (lq + BLOCK - 1) / BLOCK);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) {
    return static_cast<int>(
        launch(flash_bwd_dq_kernel<64>, smem_bytes<64>(), grid, p, s));
  }
  if (head_dim == 128) {
    return static_cast<int>(
        launch(flash_bwd_dq_kernel<128>, smem_bytes<128>(), grid, p, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
