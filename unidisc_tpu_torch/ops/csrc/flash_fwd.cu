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
//   The LSE (B, H, Lq) fp32, a natural log, is written only when asked for.
//
// Layout: q, k, v, o are (B, L, H, D) with any batch, row and head strides
// (in elements, multiples of 8) and a contiguous last dimension, so the
// kernel reads Q/K/V straight out of the model's activations with no
// transposes. Segment ids are (B, Lq) and (B, Lk) int32.
//
// Design (FlashAttention-3's shape, without its intra-warpgroup overlap):
// one block of 288 threads per (batch * head, 128-row query tile).
//   - Warp 8 is the producer. Its lane 0 loads the Q tile once and streams
//     K and V tiles of 64 keys through a ring of STAGES shared-memory
//     stages with TMA (cp.async.bulk.tensor over rank-4 (D, H, L, B) tensor
//     maps built from the strides, 128-byte swizzle, one 64-column box per
//     64 columns of D). A full and an empty mbarrier per stage carry the
//     handshake; the warp's lanes copy the tile's key segment ids into the
//     stage with cp.async, whose completion also arrives on the stage's
//     full barrier. TMA's per-dimension
//     bounds make rows at or past L read as zeros without touching the
//     next batch or head.
//   - Warps 0-3 and 4-7 are two consumer warpgroups, each owning 64 query
//     rows. S = Q K^T is wgmma m64n64k16 with both operands in shared
//     memory (K is K-major as stored). The fp32 S accumulator is rescaled,
//     masked and exponentiated in registers, then repacked in place as the
//     bf16 A operand of O += P V (wgmma from registers; V is the B operand
//     from shared memory, MN-major, with the transpose flag), one m64n64
//     product per 64 columns of D.
//   - The softmax runs in base 2: scale * log2(e) is folded into one
//     multiply, exponentials are ex2.approx, m and l stay fp32 and the LSE
//     is converted back to a natural log when it is written. Masked scores
//     take -1e30 * log2(e), so the masked-row test m > MASK / 2 still holds.
//   - No setmaxnreg: ptxas budgets registers for whole warpgroups once a
//     kernel uses it (168 a thread for this 288-thread block, 65536 / 384),
//     so a lone producer warp frees too little for the consumers to rise;
//     the launch bounds size the registers instead.
//   - The host sets the dynamic shared-memory limit once per device and
//     encodes the three tensor maps on every call (kernel parameters).
//
// Bound at the main path's shape (B 16, H 12, L 384, D 64): Q, K, V and O
// are 37.7 MB, 11 us at 3.35 TB/s; QK^T and PV are 7.25 GFLOP, 7 us at
// 989 TFLOP/s. The kernel is bound by bytes.
//
// Occupancy. D 64: shared memory 16 KB (Q) + 4 stages x 16 KB (K, V) + 1 KB
// of segment ids and barriers + 1 KB alignment slack = 82 KB; 288 threads
// under launch bounds of 2 blocks per SM (18 warps, 5 on one quarter of the
// register file: at most 102 registers a thread), so 2 blocks (16 consumer
// warps) per SM. (16,12,384,64) is 192 heads x 3
// query tiles = 576 blocks, 2.2 waves of 264; (32,12,384,64) is 1,152
// blocks, 4.4 waves. D 128: 32 KB + 2 x 32 KB + 2 KB = 98 KB, at most 168
// registers (9 warps, 3 on one quarter): 1 block per SM. ptxas -v (nvcc
// 12.9): 96 registers a thread at D 64, 155 at D 128, 0 bytes spill.
//
// What the design does about the points of the first version: loads are
// asynchronous (TMA into a 2-4 stage ring, so the next K/V tiles land while
// the current one is multiplied) and no __syncthreads runs in the loop;
// products run on wgmma; V is read by wgmma's transposed descriptor instead
// of 16-bit gathers; exponentials are ex2.approx with the scale folded in;
// 128-row tiles halve the re-reads of K and V per head against 64-row ones;
// the shared-memory attribute is set once.

#include "hopper.cuh"

#include <math.h>

namespace {

using namespace hopper;

constexpr int BLOCK_N = 64;   // keys per KV tile
constexpr float MASK_VALUE = -1e30f;
constexpr float MASK2 = MASK_VALUE * LOG2E;  // the mask in base 2
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  __nv_bfloat16* o;
  float* lse;        // (B, H, Lq) or nullptr
  const int* qseg;   // (B, Lq) or nullptr
  const int* kseg;   // (B, Lk) or nullptr (set iff qseg is)
  int H, Lq, Lk;
  long long o_sb, o_sl, o_sh;
  float scale_log2;  // scale * log2(e)
  int causal;
};

template <int D>
struct Config {
  static constexpr int CONSUMERS = 2;  // consumer warpgroups
  static constexpr int BLOCK_M = CONSUMERS * 64;  // query rows per block
  static constexpr int THREADS = CONSUMERS * 128 + 32;
  static constexpr int STAGES = D == 64 ? 4 : 2;
  static constexpr int MIN_BLOCKS = D == 64 ? 2 : 1;
  static constexpr int Q_BYTES = BLOCK_M * D * 2;
  static constexpr int KV_BYTES = BLOCK_N * D * 2;  // one of K, V
  // byte offsets into the 1024-aligned dynamic shared memory
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_KSEG = OFF_V + STAGES * KV_BYTES;
  static constexpr int OFF_BAR = OFF_KSEG + STAGES * BLOCK_N * 4;
  static constexpr int SMEM = OFF_BAR + (2 * STAGES + 1) * 8 + 1024;
};

// Scale a score tile into base 2 and apply the masks with selects (no
// per-element branches): keys past Lk take -inf, masked pairs (causal, or
// segments when SEG) an additive -1e30 * log2(e). Tracks the row maxima.
template <bool SEG>
__device__ __forceinline__ void mask_scores(float (&s)[32], float (&mx)[2],
                                            const Params& p, int k0, int t,
                                            const int (&row)[2],
                                            const int (&qs)[2],
                                            const int* tKseg) {
  const bool causal = p.causal != 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    const int cl = (i >> 2) * 8 + 2 * t + (i & 1);
    const int col = k0 + cl;
    bool ok = !causal | (col <= row[r]);
    if (SEG) ok = ok & (qs[r] == tKseg[cl]) & (qs[r] >= 0);
    float val = s[i] * p.scale_log2 + (ok ? 0.f : MASK2);
    val = col < p.Lk ? val : -INFINITY;  // past the end: contributes nothing
    s[i] = val;
    mx[r] = fmaxf(mx[r], val);
  }
}

template <int D>
__global__ void __launch_bounds__(Config<D>::THREADS, Config<D>::MIN_BLOCKS)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const Params p) {
  using C = Config<D>;
  constexpr int NB = D / 64;  // 64-column boxes of D
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem;
  unsigned char* sK = smem + C::OFF_K;
  unsigned char* sV = smem + C::OFF_V;
  int* sKseg = reinterpret_cast<int*>(smem + C::OFF_KSEG);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* empty = full + C::STAGES;
  uint64_t* bar_q = empty + C::STAGES;

  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  const int q0 = blockIdx.y * C::BLOCK_M;
  const int tid = threadIdx.x;

  int n_tiles = (p.Lk + BLOCK_N - 1) / BLOCK_N;
  if (p.causal) {
    // skip KV tiles that start past this query tile's last row
    const int q_last = min(q0 + C::BLOCK_M, p.Lq) - 1;
    n_tiles = min(n_tiles, q_last / BLOCK_N + 1);
  }

  TRACE_IF(tid == 0, 0);
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      // the TMA's expect_tx arrival and the producer lanes' cp.async ones
      mbar_init(&full[s], 1 + 32);
      mbar_init(&empty[s], C::CONSUMERS * 4);  // lane 0 of each consumer warp
    }
    mbar_init(bar_q, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= C::CONSUMERS * 128) {
    // ---- producer warp ----
    const int lane = tid & 31;
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_q, C::Q_BYTES);
      tma_load_rows<D>(sQ, &map_q, bar_q, C::BLOCK_M, h, q0, b);
    }
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int stage = kt % C::STAGES;
      const int k0 = kt * BLOCK_N;
      mbar_wait(&empty[stage], ((kt / C::STAGES) & 1) ^ 1);
      if (p.kseg != nullptr) {
        // the tile's key segment ids (zeros past Lk, where every score
        // is -inf)
#pragma unroll
        for (int i = lane; i < BLOCK_N; i += 32) {
          const bool in = k0 + i < p.Lk;
          cp_async_4(sKseg + stage * BLOCK_N + i,
                     p.kseg + (in ? b * p.Lk + k0 + i : 0), in);
        }
      }
      cp_async_arrive(&full[stage]);
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[stage], 2 * C::KV_BYTES);
        TRACE_IF(kt < 6, 40 + kt);
        tma_load_rows<D>(sK + stage * C::KV_BYTES, &map_k, &full[stage],
                         BLOCK_N, h, k0, b);
        tma_load_rows<D>(sV + stage * C::KV_BYTES, &map_v, &full[stage],
                         BLOCK_N, h, k0, b);
      }
    }
  } else {
    // ---- consumer warpgroups ----
    const int wg = tid / 128;
    const int warp = (tid % 128) / 32;
    const int lane = tid & 31;
    const int g = lane >> 2;  // fragment row group
    const int t = lane & 3;   // thread within the group
    // this thread's two query rows
    const int row[2] = {q0 + wg * 64 + warp * 16 + g,
                        q0 + wg * 64 + warp * 16 + g + 8};
    int qs[2] = {0, 0};
    if (p.qseg != nullptr) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        qs[r] = row[r] < p.Lq ? p.qseg[b * p.Lq + row[r]] : -1;
      }
    }

    float m_i[2] = {-INFINITY, -INFINITY};  // running max, base 2
    float l_i[2] = {0.f, 0.f};  // this thread's share of the row sums
    float acc[NB][32];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;
    }

    mbar_wait(bar_q, 0);
    TRACE_IF(tid == 0, 1);
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int stage = kt % C::STAGES;
      const int k0 = kt * BLOCK_N;
      const unsigned char* tK = sK + stage * C::KV_BYTES;
      const unsigned char* tV = sV + stage * C::KV_BYTES;
      const int* tKseg = sKseg + stage * BLOCK_N;
      mbar_wait(&full[stage], (kt / C::STAGES) & 1);
      TRACE_IF(tid == 0 && kt < 6, 2 + 6 * kt);

      // S = Q K^T for this warpgroup's 64 rows x 64 keys
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        wgmma_ss_64x64<0>(s, desc_kmajor(sQ, C::BLOCK_M, wg * 64, ks),
                          desc_kmajor(tK, BLOCK_N, 0, ks), ks > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_acc(s);
      TRACE_IF(tid == 0 && kt < 6, 3 + 6 * kt);

      // scale (base 2), mask, row max. Whether the tile needs a mask is
      // uniform over the block, so a full unmasked tile (the main path's)
      // runs a loop with no per-element tests.
      float mx[2] = {-INFINITY, -INFINITY};
      if (p.causal || p.qseg != nullptr || k0 + BLOCK_N > p.Lk) {
        if (p.qseg != nullptr) {
          mask_scores<true>(s, mx, p, k0, t, row, qs, tKseg);
        } else {
          mask_scores<false>(s, mx, p, k0, t, row, qs, tKseg);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          s[i] *= p.scale_log2;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // every tile holds at least one in-range key, so mx is finite
        const float m_new = fmaxf(m_i[r], mx[r]);
        alpha[r] = ex2(m_i[r] - m_new);
        m_i[r] = m_new;
      }

      // P = exp2(S - m), row sums in fp32, P packed to bf16 A fragments
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = ex2(s[i] - m_i[r]);
        rs[r] += s[i];
      }
      uint32_t pa[BLOCK_N / 16][4];
#pragma unroll
      for (int kk = 0; kk < BLOCK_N / 16; ++kk) acc_to_a(pa[kk], s, kk);
#pragma unroll
      for (int r = 0; r < 2; ++r) l_i[r] = l_i[r] * alpha[r] + rs[r];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[nb][i] *= alpha[(i >> 1) & 1];
      }

      TRACE_IF(tid == 0 && kt < 6, 4 + 6 * kt);
      // O += P V
      wgmma_fence();
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
          wgmma_rs_64x64<1>(acc[nb], pa[kk],
                            desc_mnmajor(tV, BLOCK_N, nb, kk), 1);
        }
      }
      wgmma_commit();
      TRACE_IF(tid == 0 && kt < 6, 5 + 6 * kt);
      wgmma_wait0();
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) fence_acc(acc[nb]);
      TRACE_IF(tid == 0 && kt < 6, 6 + 6 * kt);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      TRACE_IF(tid == 0 && kt < 6, 7 + 6 * kt);
    }

    float inv[2], lse[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_i[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const bool valid = m_i[r] > MASK2 * 0.5f;
      inv[r] = valid ? 1.f / fmaxf(l, 1e-30f) : 0.f;
      lse[r] = valid ? (m_i[r] + log2f(fmaxf(l, 1e-30f))) * LN2 : 0.f;
    }

    __nv_bfloat16* obase = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= p.Lq) continue;
      __nv_bfloat16* orow = obase + row[r] * p.o_sl + 2 * t;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          *reinterpret_cast<uint32_t*>(orow + nb * 64 + j * 8) =
              pack_bf16x2(acc[nb][4 * j + 2 * r] * inv[r],
                          acc[nb][4 * j + 2 * r + 1] * inv[r]);
        }
      }
      if (p.lse != nullptr && t == 0) {
        p.lse[(static_cast<long long>(b) * p.H + h) * p.Lq + row[r]] = lse[r];
      }
    }
    TRACE_IF(tid == 0, 62);
  }
}

// Encode the three tensor maps (q in boxes of the block's rows, k and v in
// 64-row boxes) and launch on `stream`.
template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const long long (&st)[9], int batch, const Params& p,
                   cudaStream_t stream) {
  using C = Config<D>;
  CUtensorMap mq, mk, mv;
  cudaError_t err = encode_bhld(&mq, q, batch, p.Lq, p.H, D, st[0], st[1],
                                st[2], C::BLOCK_M);
  if (err == cudaSuccess) {
    err = encode_bhld(&mk, k, batch, p.Lk, p.H, D, st[3], st[4], st[5],
                      BLOCK_N);
  }
  if (err == cudaSuccess) {
    err = encode_bhld(&mv, v, batch, p.Lk, p.H, D, st[6], st[7], st[8],
                      BLOCK_N);
  }
  if (err != cudaSuccess) return err;
  static unsigned long long smem_set = 0;
  err = set_smem_once(flash_fwd_kernel<D>, C::SMEM, &smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * p.H, (p.Lq + C::BLOCK_M - 1) / C::BLOCK_M);
  flash_fwd_kernel<D><<<grid, C::THREADS, C::SMEM, stream>>>(mq, mk, mv, p);
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
  if (head_dim != 64 && head_dim != 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.H = heads;
  p.Lq = lq;
  p.Lk = lk;
  p.o_sb = o_sb; p.o_sl = o_sl; p.o_sh = o_sh;
  p.scale_log2 = scale * LOG2E;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long st[9] = {q_sb, q_sl, q_sh, k_sb, k_sl, k_sh,
                           v_sb, v_sl, v_sh};
  if (head_dim == 64) return static_cast<int>(launch<64>(q, k, v, st, batch, p, s));
  return static_cast<int>(launch<128>(q, k, v, st, batch, p, s));
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
