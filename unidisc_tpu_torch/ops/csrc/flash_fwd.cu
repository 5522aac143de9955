// Attention forward for Hopper (sm_90a), bf16 in and out, fp32 accumulation.
//
// Replaces the JAX package's Pallas TPU kernels
//   unidisc_tpu/ops/pallas_attention.py:119  _small_fwd_kernel  (L <= 640)
//   unidisc_tpu/ops/pallas_attention.py:47   _fwd_kernel        (L > 640)
// with one kernel that serves every length: an inner loop over KV tiles
// with an fp32 online softmax (m, l, acc), so the TPU's L <= 640 / L > 640
// split, its head batching and its (8, 128) padding are not carried over.
//
// Semantics (identical to both TPU kernels):
//   S = Q K^T * scale, accumulated in fp32 from bf16 products;
//   optional causal mask (key <= query, indices from the sequence start)
//   and segment mask (qseg == kseg && qseg >= 0), applied as an additive
//   -1e30; P = exp(S - m) is rounded to bf16 before P V; O is normalised
//   after P V. A row with no allowed key gives O = 0 and LSE = 0.
//   The LSE (B, H, Lq) fp32 is written only when asked for.
//
// Layout: q, k, v, o are (B, L, H, D) with any batch, row and head strides
// (in elements, multiples of 8) and a contiguous last dimension, so the
// kernel reads Q/K/V straight out of the model's activations with no
// transposes. Segment ids are (B, Lq) and (B, Lk) int32.
//
// Design: one thread block of 4 warps per (batch * head, 64-row query
// tile); each warp owns 16 query rows. Q, K and V tiles are staged in
// shared memory (rows padded by 8 elements, so the fragment loads are free
// of bank conflicts). Products use mma.sync m16n8k16 bf16 -> fp32; the
// score accumulator is reused in registers as the A operand of P V.
//
// Bound at the main path's shape (B 16, H 12, L 384, D 64): Q, K, V and O
// are 37.7 MB, 11 us at 3.35 TB/s; QK^T and PV are 7.25 GFLOP, 7 us at
// 989 TFLOP/s. The kernel is bound by bytes.
//
// What this simple design leaves on the table: loads are synchronous
// (no cp.async or TMA double buffering, so load latency is not hidden
// behind the MMAs); mma.sync reaches a fraction of what wgmma does; K and
// V are re-read from L2 by each of the L/64 query tiles of a head; the V
// operand is gathered with 16-bit shared-memory loads rather than
// ldmatrix.trans.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;   // query rows per block
constexpr int BLOCK_N = 64;   // keys per KV tile
constexpr int THREADS = 128;  // 4 warps x 16 query rows
constexpr int PAD = 8;        // shared-memory row padding, in elements
constexpr float MASK_VALUE = -1e30f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;        // (B, H, Lq) or nullptr
  const int* qseg;   // (B, Lq) or nullptr
  const int* kseg;   // (B, Lk) or nullptr (set iff qseg is)
  int H, Lq, Lk;
  long long q_sb, q_sl, q_sh;
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  long long o_sb, o_sl, o_sh;
  float scale;
  int causal;
};

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
  for (int idx = tid; idx < 64 * CHUNKS; idx += THREADS) {
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

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const Params p) {
  constexpr int LDS = D + PAD;
  constexpr int KD = D / 16;        // k-steps of QK^T
  constexpr int ND = D / 8;         // n-tiles of the output
  constexpr int NS = BLOCK_N / 8;   // n-tiles of the score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BLOCK_M * LDS;
  __nv_bfloat16* sV = sK + BLOCK_N * LDS;
  int* sKseg = reinterpret_cast<int*>(sV + BLOCK_N * LDS);

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.y * BLOCK_M;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread within the group

  const __nv_bfloat16* qbase = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kbase = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vbase = p.v + b * p.v_sb + h * p.v_sh;

  load_tile<D>(sQ, qbase, p.q_sl, q0, p.Lq, tid);
  __syncthreads();

  // this thread's two query rows: local r_lo and r_lo + 8 of the warp's 16
  const int r_lo = warp * 16 + g;
  const int row[2] = {q0 + r_lo, q0 + r_lo + 8};

  uint32_t qa[KD][4];
#pragma unroll
  for (int kc = 0; kc < KD; ++kc) {
    const __nv_bfloat16* lo = sQ + r_lo * LDS + kc * 16 + 2 * t;
    const __nv_bfloat16* hi = lo + 8 * LDS;
    qa[kc][0] = *reinterpret_cast<const uint32_t*>(lo);
    qa[kc][1] = *reinterpret_cast<const uint32_t*>(hi);
    qa[kc][2] = *reinterpret_cast<const uint32_t*>(lo + 8);
    qa[kc][3] = *reinterpret_cast<const uint32_t*>(hi + 8);
  }

  int qs[2] = {0, 0};
  if (p.qseg != nullptr) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      qs[r] = row[r] < p.Lq ? p.qseg[b * p.Lq + row[r]] : -1;
    }
  }

  float m_i[2] = {-INFINITY, -INFINITY};
  float l_i[2] = {0.f, 0.f};  // this thread's share of the row sums
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }

  int n_tiles = (p.Lk + BLOCK_N - 1) / BLOCK_N;
  if (p.causal) {
    // skip KV tiles that start past this query tile's last row
    const int q_last = min(q0 + BLOCK_M, p.Lq) - 1;
    n_tiles = min(n_tiles, q_last / BLOCK_N + 1);
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BLOCK_N;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(sK, kbase, p.k_sl, k0, p.Lk, tid);
    load_tile<D>(sV, vbase, p.v_sl, k0, p.Lk, tid);
    if (p.kseg != nullptr && tid < BLOCK_N) {
      sKseg[tid] = k0 + tid < p.Lk ? p.kseg[b * p.Lk + k0 + tid] : -2;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    }
#pragma unroll
    for (int kc = 0; kc < KD; ++kc) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const __nv_bfloat16* kr = sK + (j * 8 + g) * LDS + kc * 16 + 2 * t;
        mma_16816(s[j], qa[kc], *reinterpret_cast<const uint32_t*>(kr),
                  *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // scale, mask, row max
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int cl = j * 8 + 2 * t + (e & 1);
        const int col = k0 + cl;
        float val = s[j][e] * p.scale;
        if (col >= p.Lk) {
          val = -INFINITY;  // past the end: contributes nothing
        } else {
          bool ok = true;
          if (p.causal) ok = col <= row[r];
          if (p.qseg != nullptr) {
            ok = ok && qs[r] == sKseg[cl] && qs[r] >= 0;
          }
          if (!ok) val += MASK_VALUE;
        }
        s[j][e] = val;
        mx[r] = fmaxf(mx[r], val);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // every tile holds at least one in-range key, so mx is finite
      const float m_new = fmaxf(m_i[r], mx[r]);
      alpha[r] = expf(m_i[r] - m_new);
      m_i[r] = m_new;
    }

    // P = exp(S - m), row sums in fp32, P packed to bf16 A fragments
    uint32_t pa[BLOCK_N / 16][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float p0 = expf(s[j][0] - m_i[0]);
      const float p1 = expf(s[j][1] - m_i[0]);
      const float p2 = expf(s[j][2] - m_i[1]);
      const float p3 = expf(s[j][3] - m_i[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      const int kk = j >> 1;
      const int slot = (j & 1) * 2;
      pa[kk][slot + 0] = pack_floats(p0, p1);
      pa[kk][slot + 1] = pack_floats(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_i[r] = l_i[r] * alpha[r] + rs[r];
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat16* vc = sV + (kk * 16 + 2 * t) * LDS + n * 8 + g;
        const uint32_t b0 = pack_bf16(vc[0], vc[LDS]);
        const uint32_t b1 = pack_bf16(vc[8 * LDS], vc[9 * LDS]);
        mma_16816(acc[n], pa[kk], b0, b1);
      }
    }
  }

  float inv[2], lse[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_i[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const bool valid = m_i[r] > MASK_VALUE * 0.5f;
    inv[r] = valid ? 1.f / fmaxf(l, 1e-30f) : 0.f;
    lse[r] = valid ? m_i[r] + logf(fmaxf(l, 1e-30f)) : 0.f;
  }

  __nv_bfloat16* obase = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= p.Lq) continue;
    __nv_bfloat16* orow = obase + row[r] * p.o_sl + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_floats(acc[n][2 * r] * inv[r], acc[n][2 * r + 1] * inv[r]);
    }
    if (p.lse != nullptr && t == 0) {
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Lq + row[r]] = lse[r];
    }
  }
}

template <int D>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  const int smem = (BLOCK_M + 2 * BLOCK_N) * (D + PAD) *
                       static_cast<int>(sizeof(__nv_bfloat16)) +
                   BLOCK_N * static_cast<int>(sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * p.H, (p.Lq + BLOCK_M - 1) / BLOCK_M);
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success). Shapes and strides are checked by
// the Python wrapper; head_dim must be 64 or 128.
int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                   void* lse, const void* qseg, const void* kseg, int batch,
                   int heads, int lq, int lk, int head_dim, long long q_sb,
                   long long q_sl, long long q_sh, long long k_sb,
                   long long k_sl, long long k_sh, long long v_sb,
                   long long v_sl, long long v_sh, long long o_sb,
                   long long o_sl, long long o_sh, float scale, int causal,
                   void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.H = heads;
  p.Lq = lq;
  p.Lk = lk;
  p.q_sb = q_sb; p.q_sl = q_sl; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sl = k_sl; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_sl = v_sl; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_sl = o_sl; p.o_sh = o_sh;
  p.scale = scale;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return static_cast<int>(launch<64>(p, batch, s));
  if (head_dim == 128) return static_cast<int>(launch<128>(p, batch, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
