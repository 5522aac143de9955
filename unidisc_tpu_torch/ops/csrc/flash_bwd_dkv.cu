// Attention backward, dK and dV, for Hopper (sm_90a): bf16 in and out,
// fp32 accumulation.
//
// Replaces the JAX package's Pallas TPU kernel
//   unidisc_tpu/ops/pallas_attention.py:402  _bwd_dkv_kernel
// It runs after flash_bwd_dq_kernel (flash_bwd_dq.cu) on the same stream
// and reads the di = rowsum(O * dO) that kernel writes.
//
// Semantics (identical to _masked_p and the TPU kernel):
//   S = Q K^T * scale in fp32 from bf16 products; masked (query, key) pairs
//   (causal: key > query; segments: qseg != kseg or qseg < 0) get an
//   additive -1e30; P = exp(S - LSE) with the forward's LSE (a natural
//   log); a row with no allowed key has LSE 0, so its share of dK and dV is
//   0. dP = dO V^T; dS = P * (dP - di) * scale; dV = P^T dO; dK = dS^T Q.
//   Keys at or past Lk and queries at or past Lq contribute nothing. P and
//   dS are rounded to bf16 as the A operand of the second product of each
//   pair. No atomics: each block writes its dK and dV rows once, so the
//   result is deterministic.
//
// Layout: q, k, v, dO, dk, dv are (B, L, H, D) with any batch, row and head
// strides (in elements, multiples of 8) and a contiguous last dimension;
// LSE and di are (B, H, Lq) fp32; segment ids (B, Lq) and (B, Lk) int32.
//
// Design: one block per (batch * head, key tile): D 64 runs 128-key tiles
// with two consumer warpgroups, D 128 64-key tiles with one (Config).
//   - The last warp is the producer. Its lane 0 loads the block's K and V
//     tiles once with TMA (rank-4 (D, H, L, B) tensor maps, 128-byte
//     swizzle) and streams 64-query tiles of Q and dO through a ring of
//     STAGES stages, each with a full and an empty mbarrier; beside each
//     TMA the warp's lanes copy the tile's LSE, di and query segment ids
//     into the stage with cp.async, whose completion also arrives on the
//     stage's full barrier, so the producer never waits on a global load.
//     Rows past L read as zeros.
//   - Each consumer warpgroup owns 64 keys. S^T = K Q^T and dP^T = V dO^T
//     are wgmma m64n64k16 with both operands in shared memory (Q and dO
//     are K-major for these products as stored). P^T = exp2(S^T * scale *
//     log2(e) - LSE * log2(e)) and dS^T are formed in registers and
//     repacked in place as the bf16 A operands of dV += P^T dO and
//     dK += dS^T Q, whose B operands (dO, Q) are read MN-major from shared
//     memory with the transpose flag.
//   - No setmaxnreg (see flash_fwd.cu); the launch bounds size the
//     registers. The shared-memory limit is set once per device.
//
// Registers. A consumer thread holds dK and dV for 64 keys x D: 2 x D / 2
// fp32 (D 64: 64; D 128: 128, i.e. 64 each for a 64 x 128 tile), S^T and
// dP^T for 64 keys x 64 queries (2 x 32), and the bf16 A fragments of P^T
// and dS^T (2 x 16, which take the place of S^T and dP^T as they are
// formed): about 130 for D 64 and 200 for D 128. A quarter of the SM's
// register file (16,384) serves every fourth warp: the 9 warps of a D 64
// block put 3 on one quarter, at most 168 registers a thread; the 5 warps
// of a D 128 block at most 2, up to 255. ptxas -v (nvcc 12.9): 168
// registers a thread at D 64, 254 at D 128, 0 bytes spill.
//
// Shared memory. D 64: K, V 32 KB + 4 stages x (Q, dO 16 KB + 768 B) =
// 99 KB; D 128: 32 KB + 3 x 32.75 KB = 130 KB; one block per SM (the
// registers decide). (32,12,384,64) is 384 heads x 3 key tiles = 1,152
// blocks, 8.7 waves of 132.
//
// Bound at the train path's shape (B 32, H 12, L 384, D 64): q, k, v, dO,
// dk, dv are 113 MB and LSE, di 1.2 MB, 34 us at 3.35 TB/s; the four
// products are 8 D FLOPs per (query, key) pair, 29 GFLOP, 29 us at 989
// TFLOP/s: bound by bytes, near the ridge.
//
// What the design does about the first version: loads are asynchronous
// (TMA ring, K and V loaded once per block); no __syncthreads runs in the
// loop; all four products run on wgmma; the transposed B operands are read
// by wgmma's MN-major descriptors instead of 16-bit gathers; exponentials
// are ex2.approx with the scale folded in; at D 64, 128-key tiles halve the
// re-reads of Q and dO per head against 64-key ones.

#include "hopper.cuh"

#include <math.h>

namespace {

using namespace hopper;

constexpr int BLOCK_M = 64;   // queries per streamed tile
constexpr float MASK2 = -1e30f * LOG2E;  // the additive mask in base 2

struct Params {
  const float* lse;  // (B, H, Lq)
  const float* di;   // (B, H, Lq), written by the dq kernel
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  const int* qseg;   // (B, Lq) or nullptr
  const int* kseg;   // (B, Lk) or nullptr (set iff qseg is)
  int H, Lq, Lk;
  long long dk_sb, dk_sl, dk_sh;
  long long dv_sb, dv_sl, dv_sh;
  float scale;
  float scale_log2;  // scale * log2(e)
  int causal;
};

// D 64: two consumer warpgroups (128 keys a block) and the producer warp,
// 288 threads. Each quarter of the SM's register file (16,384) serves every
// fourth warp, so 9 warps put 3 on one quarter: at most 168 registers a
// thread, which D 64 fits. D 128 needs more (dK and dV alone are 128 a
// thread), so it runs one consumer warpgroup (64 keys a block), 160 threads
// of up to 255 registers.
template <int D>
struct Config {
  static constexpr int CONSUMERS = D == 64 ? 2 : 1;
  static constexpr int BLOCK_N = CONSUMERS * 64;  // keys per block
  static constexpr int THREADS = CONSUMERS * 128 + 32;
  static constexpr int STAGES = D == 64 ? 4 : 3;
  static constexpr int KV_BYTES = BLOCK_N * D * 2;  // one of K, V
  static constexpr int QD_BYTES = BLOCK_M * D * 2;  // one of Q, dO
  static constexpr int OFF_V = KV_BYTES;
  static constexpr int OFF_Q = 2 * KV_BYTES;
  static constexpr int OFF_DO = OFF_Q + STAGES * QD_BYTES;
  static constexpr int OFF_ROWS = OFF_DO + STAGES * QD_BYTES;  // lse, di, qseg
  static constexpr int OFF_BAR = OFF_ROWS + STAGES * 3 * BLOCK_M * 4;
  static constexpr int SMEM = OFF_BAR + (2 * STAGES + 1) * 8 + 1024;
};

// P^T and dS^T of a tile that needs masks, with selects (no per-element
// branches): pairs past Lq or Lk give 0, masked pairs (causal, or segments
// when SEG) take an additive -1e30 * log2(e) before the exponential.
template <bool SEG>
__device__ __forceinline__ void masked_p_ds(float (&s)[32], float (&dp)[32],
                                            const Params& p, int q0, int t,
                                            const int (&key)[2],
                                            const int (&ks)[2],
                                            const float* tLse,
                                            const float* tDi,
                                            const int* tQseg) {
  const bool causal = p.causal != 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cl = 8 * j + 2 * t + e;
      const int qrow = q0 + cl;
      const float lse2 = tLse[cl] * LOG2E;
      const float di = tDi[cl];
      const int qs = SEG ? tQseg[cl] : 0;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * j + 2 * r + e;
        bool ok = !causal | (key[r] <= qrow);
        if (SEG) ok = ok & (qs == ks[r]) & (qs >= 0);
        const float val = s[i] * p.scale_log2 + (ok ? 0.f : MASK2);
        const bool in = (qrow < p.Lq) & (key[r] < p.Lk);
        const float pv = in ? ex2(val - lse2) : 0.f;
        s[i] = pv;
        dp[i] = pv * (dp[i] - di) * p.scale;
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(Config<D>::THREADS, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do,
                         const Params p) {
  using C = Config<D>;
  constexpr int NB = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sK = smem;
  unsigned char* sV = smem + C::OFF_V;
  unsigned char* sQ = smem + C::OFF_Q;
  unsigned char* sDO = smem + C::OFF_DO;
  float* sRows = reinterpret_cast<float*>(smem + C::OFF_ROWS);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* empty = full + C::STAGES;
  uint64_t* bar_kv = empty + C::STAGES;

  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  const int k0 = blockIdx.y * C::BLOCK_N;
  const int tid = threadIdx.x;
  const long long bh_row = (static_cast<long long>(b) * p.H + h) * p.Lq;

  const int n_tiles = (p.Lq + BLOCK_M - 1) / BLOCK_M;
  // causal: query tiles that end before this key tile starts see none of
  // its keys
  const int first = p.causal ? k0 / BLOCK_M : 0;

  TRACE_IF(tid == 0, 0);
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      // the TMA's expect_tx arrival and the producer lanes' cp.async ones
      mbar_init(&full[s], 1 + 32);
      mbar_init(&empty[s], C::CONSUMERS * 4);  // lane 0 of each consumer warp
    }
    mbar_init(bar_kv, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= C::CONSUMERS * 128) {
    // ---- producer warp ----
    const int lane = tid & 31;
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_kv, 2 * C::KV_BYTES);
      tma_load_rows<D>(sK, &map_k, bar_kv, C::BLOCK_N, h, k0, b);
      tma_load_rows<D>(sV, &map_v, bar_kv, C::BLOCK_N, h, k0, b);
    }
    for (int qt = first; qt < n_tiles; ++qt) {
      const int it = qt - first;
      const int stage = it % C::STAGES;
      const int q0 = qt * BLOCK_M;
      mbar_wait(&empty[stage], ((it / C::STAGES) & 1) ^ 1);
      TRACE_IF(lane == 0 && it < 6, 46 + it);
      // LSE, di and query segment ids of the tile's rows (zeros past Lq)
      float* rows = sRows + stage * 3 * BLOCK_M;
#pragma unroll
      for (int i = lane; i < BLOCK_M; i += 32) {
        const bool in = q0 + i < p.Lq;
        const long long at = in ? bh_row + q0 + i : 0;
        cp_async_4(rows + i, p.lse + at, in);
        cp_async_4(rows + BLOCK_M + i, p.di + at, in);
        if (p.qseg != nullptr) {
          cp_async_4(rows + 2 * BLOCK_M + i,
                     p.qseg + (in ? b * p.Lq + q0 + i : 0), in);
        }
      }
      cp_async_arrive(&full[stage]);
      if (lane == 0) {
        TRACE_IF(it < 6, 40 + it);
        mbar_arrive_expect_tx(&full[stage], 2 * C::QD_BYTES);
        tma_load_rows<D>(sQ + stage * C::QD_BYTES, &map_q, &full[stage],
                         BLOCK_M, h, q0, b);
        tma_load_rows<D>(sDO + stage * C::QD_BYTES, &map_do, &full[stage],
                         BLOCK_M, h, q0, b);
      }
    }
  } else {
    // ---- consumer warpgroups ----
    const int wg = tid / 128;
    const int warp = (tid % 128) / 32;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    // this thread's two keys
    const int key[2] = {k0 + wg * 64 + warp * 16 + g,
                        k0 + wg * 64 + warp * 16 + g + 8};
    int ks[2] = {0, 0};
    if (p.kseg != nullptr) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        ks[r] = key[r] < p.Lk ? p.kseg[b * p.Lk + key[r]] : -2;
      }
    }

    float dk[NB][32], dv[NB][32];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int i = 0; i < 32; ++i) dk[nb][i] = dv[nb][i] = 0.f;
    }

    mbar_wait(bar_kv, 0);
    TRACE_IF(tid == 0, 1);
    for (int qt = first; qt < n_tiles; ++qt) {
      const int it = qt - first;
      const int stage = it % C::STAGES;
      const int q0 = qt * BLOCK_M;
      const unsigned char* tQ = sQ + stage * C::QD_BYTES;
      const unsigned char* tDO = sDO + stage * C::QD_BYTES;
      const float* tLse = sRows + stage * 3 * BLOCK_M;
      const float* tDi = tLse + BLOCK_M;
      const int* tQseg = reinterpret_cast<const int*>(tLse + 2 * BLOCK_M);
      mbar_wait(&full[stage], (it / C::STAGES) & 1);
      TRACE_IF(tid == 0 && it < 6, 2 + 6 * it);

      // S^T = K Q^T and dP^T = V dO^T for this warpgroup's 64 keys
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        wgmma_ss_64x64<0>(s, desc_kmajor(sK, C::BLOCK_N, wg * 64, kc),
                          desc_kmajor(tQ, BLOCK_M, 0, kc), kc > 0);
      }
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        wgmma_ss_64x64<0>(dp, desc_kmajor(sV, C::BLOCK_N, wg * 64, kc),
                          desc_kmajor(tDO, BLOCK_M, 0, kc), kc > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_acc(s);
      fence_acc(dp);
      TRACE_IF(tid == 0 && it < 6, 3 + 6 * it);

      // P^T into s, dS^T into dp. Whether the tile needs a mask is uniform
      // over the block, so a full unmasked tile (the main path's) runs a
      // loop with no per-element tests.
      if (p.causal || p.qseg != nullptr || q0 + BLOCK_M > p.Lq ||
          k0 + C::BLOCK_N > p.Lk) {
        if (p.qseg != nullptr) {
          masked_p_ds<true>(s, dp, p, q0, t, key, ks, tLse, tDi, tQseg);
        } else {
          masked_p_ds<false>(s, dp, p, q0, t, key, ks, tLse, tDi, tQseg);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cl = 8 * j + 2 * t + e;
            const float lse2 = tLse[cl] * LOG2E;
            const float di = tDi[cl];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = 4 * j + 2 * r + e;
              const float pv = ex2(s[i] * p.scale_log2 - lse2);
              s[i] = pv;
              dp[i] = pv * (dp[i] - di) * p.scale;
            }
          }
        }
      }
      uint32_t pa[BLOCK_M / 16][4], da[BLOCK_M / 16][4];
#pragma unroll
      for (int kk = 0; kk < BLOCK_M / 16; ++kk) {
        acc_to_a(pa[kk], s, kk);
        acc_to_a(da[kk], dp, kk);
      }

      TRACE_IF(tid == 0 && it < 6, 4 + 6 * it);
      // dV += P^T dO, dK += dS^T Q
      wgmma_fence();
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int kk = 0; kk < BLOCK_M / 16; ++kk) {
          wgmma_rs_64x64<1>(dv[nb], pa[kk], desc_mnmajor(tDO, BLOCK_M, nb, kk),
                            1);
        }
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int kk = 0; kk < BLOCK_M / 16; ++kk) {
          wgmma_rs_64x64<1>(dk[nb], da[kk], desc_mnmajor(tQ, BLOCK_M, nb, kk),
                            1);
        }
      }
      wgmma_commit();
      TRACE_IF(tid == 0 && it < 6, 5 + 6 * it);
      wgmma_wait0();
      TRACE_IF(tid == 0 && it < 6, 6 + 6 * it);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        fence_acc(dv[nb]);
        fence_acc(dk[nb]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      TRACE_IF(tid == 0 && it < 6, 7 + 6 * it);
    }

    __nv_bfloat16* dkb = p.dk + b * p.dk_sb + h * p.dk_sh;
    __nv_bfloat16* dvb = p.dv + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (key[r] >= p.Lk) continue;
      __nv_bfloat16* dkrow = dkb + key[r] * p.dk_sl + 2 * t;
      __nv_bfloat16* dvrow = dvb + key[r] * p.dv_sl + 2 * t;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          *reinterpret_cast<uint32_t*>(dkrow + nb * 64 + j * 8) =
              pack_bf16x2(dk[nb][4 * j + 2 * r], dk[nb][4 * j + 2 * r + 1]);
          *reinterpret_cast<uint32_t*>(dvrow + nb * 64 + j * 8) =
              pack_bf16x2(dv[nb][4 * j + 2 * r], dv[nb][4 * j + 2 * r + 1]);
        }
      }
    }
    TRACE_IF(tid == 0, 62);
  }
}

// Encode the four tensor maps (q and dO in 64-row boxes, k and v in boxes
// of the block's keys) and launch on `stream`. `strides` as in
// flash_bwd_dkv_bf16.
template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const long long* strides, int batch,
                   const Params& p, cudaStream_t stream) {
  using C = Config<D>;
  const long long* sq = strides;
  const long long* sk = strides + 3;
  const long long* sv = strides + 6;
  const long long* sdo = strides + 12;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t err = encode_bhld(&mq, q, batch, p.Lq, p.H, D, sq[0], sq[1],
                                sq[2], BLOCK_M);
  if (err == cudaSuccess) {
    err = encode_bhld(&mk, k, batch, p.Lk, p.H, D, sk[0], sk[1], sk[2],
                      C::BLOCK_N);
  }
  if (err == cudaSuccess) {
    err = encode_bhld(&mv, v, batch, p.Lk, p.H, D, sv[0], sv[1], sv[2],
                      C::BLOCK_N);
  }
  if (err == cudaSuccess) {
    err = encode_bhld(&mdo, dout, batch, p.Lq, p.H, D, sdo[0], sdo[1],
                      sdo[2], BLOCK_M);
  }
  if (err != cudaSuccess) return err;
  static unsigned long long smem_set = 0;
  err = set_smem_once(flash_bwd_dkv_kernel<D>, C::SMEM, &smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * p.H, (p.Lk + C::BLOCK_N - 1) / C::BLOCK_N);
  flash_bwd_dkv_kernel<D><<<grid, C::THREADS, C::SMEM, stream>>>(
      mq, mk, mv, mdo, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success). Shapes, strides and types are
// checked by the Python wrapper; head_dim must be 64 or 128. `strides`
// holds (batch, row, head) strides, in elements, of q, k, v, o, dout, dq,
// dk, dv in that order (o and dq are not read). Must run after
// flash_bwd_dq_bf16 on the same stream: it reads the di that one writes.
int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* di,
                       void* dk, void* dv, const void* qseg, const void* kseg,
                       int batch, int heads, int lq, int lk, int head_dim,
                       const long long* strides, float scale, int causal,
                       void* stream) {
  if (head_dim != 64 && head_dim != 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long* sdk = strides + 18;
  const long long* sdv = strides + 21;
  Params p;
  p.lse = static_cast<const float*>(lse);
  p.di = static_cast<const float*>(di);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.H = heads;
  p.Lq = lq;
  p.Lk = lk;
  p.dk_sb = sdk[0]; p.dk_sl = sdk[1]; p.dk_sh = sdk[2];
  p.dv_sb = sdv[0]; p.dv_sl = sdv[1]; p.dv_sh = sdv[2];
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) {
    return static_cast<int>(launch<64>(q, k, v, dout, strides, batch, p, s));
  }
  return static_cast<int>(launch<128>(q, k, v, dout, strides, batch, p, s));
}

const char* flash_bwd_dkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
