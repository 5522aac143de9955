// Attention backward, dQ (and di = rowsum(O * dO)), for Hopper (sm_90a):
// bf16 in and out, fp32 accumulation.
//
// Replaces the JAX package's Pallas TPU kernel
//   unidisc_tpu/ops/pallas_attention.py:449  _bwd_dq_kernel   (dQ)
// in the FlashAttention-2 split of the backward; its partner, the port of
//   unidisc_tpu/ops/pallas_attention.py:402  _bwd_dkv_kernel  (dK, dV)
// is flash_bwd_dkv.cu, launched after this one on the same stream. This
// kernel also computes di = rowsum(O * dO) for its rows (JAX computes di
// outside its kernels, pallas_attention.py:494) and writes it to a
// (B, H, Lq) fp32 buffer, which the dkv kernel reads.
//
// Semantics (identical to _masked_p and the TPU kernel):
//   S = Q K^T * scale in fp32 from bf16 products; masked (query, key) pairs
//   (causal: key > query; segments: qseg != kseg or qseg < 0) get an
//   additive -1e30; P = exp(S - LSE) with the forward's LSE (a natural
//   log); a row with no allowed key has LSE 0, so its P and dQ are 0.
//   dP = dO V^T; dS = P * (dP - di) * scale; dQ = dS K. Keys at or past Lk
//   contribute nothing. dS is rounded to bf16 as the A operand of dS K (the
//   JAX kernel keeps it in fp32). No atomics: each block writes its dQ rows
//   once, so the result is the same on every launch.
//
// Layout: q, k, v, o, dO, dq are (B, L, H, D) with any batch, row and head
// strides (in elements, multiples of 8) and a contiguous last dimension;
// LSE and di are (B, H, Lq) fp32; segment ids (B, Lq) and (B, Lk) int32.
//
// Design: one block per (batch * head, query tile): D 64 runs 128-query
// tiles with two consumer warpgroups, D 128 64-query tiles with one
// (Config), as flash_bwd_dkv.cu does with its key tiles.
//   - The last warp is the producer. Its lane 0 loads the block's Q, dO and
//     O rows once with TMA (rank-4 (D, H, L, B) tensor maps, 128-byte
//     swizzle) and streams 64-key tiles of K and V through a ring of STAGES
//     stages, each with a full and an empty mbarrier. Its lanes copy the
//     block's LSE and query segment ids (at the prologue) and each tile's
//     key segment ids (into the stage) with cp.async, whose completion
//     arrives on the same barrier as the TMA, so the producer never waits
//     on a global load. Rows past L read as zeros.
//   - Each consumer warpgroup owns 64 queries. It first forms di for its
//     rows from the O and dO tiles in shared memory. Per key tile, S = Q K^T
//     and dP = dO V^T are wgmma m64n64k16 with both operands in shared
//     memory (K and V are K-major for these products as stored);
//     P = exp2(S * scale * log2(e) - LSE * log2(e)) and dS are formed in
//     registers and repacked in place as the bf16 A operand of dQ += dS K,
//     whose B operand K is read MN-major from the same stage.
//   - Whether a tile needs a mask is uniform over the block: full unmasked
//     tiles (all of the main path's) run a loop with no per-element tests,
//     masked ones use selects; causal key tiles past the block's last query
//     are skipped.
//   - No setmaxnreg (see flash_fwd.cu); the launch bounds size the
//     registers. The shared-memory limit is set once per device.
//
// Registers. A consumer thread holds dQ for 64 queries x D (D / 2 fp32:
// 32 at D 64, 64 at D 128), S and dP for 64 queries x 64 keys (2 x 32) and
// the bf16 A fragments of dS (16, which take the place of dP as it is
// formed). The 9 warps of a D 64 block put 3 on one quarter of the register
// file: at most 168 registers a thread; the 5 warps of a D 128 block at most
// 2, up to 255. ptxas -v (nvcc 12.9): 128 registers a thread at D 64, 162
// at D 128, 0 bytes spill. At D 64, blocks of one consumer warpgroup (64
// queries), two or three a SM, measured slower: 0.103-0.106 ms against
// 0.095 at (32,12,384,64) on an H100.
//
// Shared memory. D 64: Q, dO, O 48 KB + 4 stages x (K, V 16 KB + 256 B) +
// 1 KB of row data = 114 KB; D 128: 48 KB + 3 x 32.25 KB + 0.5 KB = 146 KB;
// one block per SM (the registers decide). (32,12,384,64) is 384 heads x 3
// query tiles = 1,152 blocks, 8.7 waves of 132.
//
// Bound at the train path's shape (B 32, H 12, L 384, D 64): q, k, v, o,
// dO, dq are 113 MB and LSE, di 1.2 MB, 34 us at 3.35 TB/s; the three
// products are 6 D FLOPs per (query, key) pair, 22 GFLOP, 22 us at 989
// TFLOP/s: bound by bytes.
//
// What the design does about the first version (synchronous loads,
// mma.sync, 16-bit gathers of the transposed K): loads are asynchronous
// (TMA ring, Q, dO and O loaded once per block); no __syncthreads runs in
// the loop; all three products run on wgmma; K is read by wgmma's MN-major
// descriptor; exponentials are ex2.approx with the scale folded in; at
// D 64, 128-query tiles halve the re-reads of K and V per head.

#include "hopper.cuh"

#include <math.h>

namespace {

using namespace hopper;

constexpr int BLOCK_N = 64;   // keys per streamed tile
constexpr float MASK2 = -1e30f * LOG2E;  // the additive mask in base 2

struct Params {
  const float* lse;  // (B, H, Lq)
  float* di;         // (B, H, Lq), written here, read by the dkv kernel
  __nv_bfloat16* dq;
  const int* qseg;   // (B, Lq) or nullptr
  const int* kseg;   // (B, Lk) or nullptr (set iff qseg is)
  int H, Lq, Lk;
  long long dq_sb, dq_sl, dq_sh;
  float scale;
  float scale_log2;  // scale * log2(e)
  int causal;
};

// D 64: two consumer warpgroups (128 queries a block) and the producer
// warp, 288 threads of at most 168 registers; D 128 (dQ alone is 64
// registers a thread) one consumer warpgroup, 160 threads.
template <int D>
struct Config {
  static constexpr int CONSUMERS = D == 64 ? 2 : 1;
  static constexpr int BLOCK_M = CONSUMERS * 64;  // queries per block
  static constexpr int THREADS = CONSUMERS * 128 + 32;
  static constexpr int STAGES = D == 64 ? 4 : 3;
  static constexpr int ROWS_BYTES = BLOCK_M * D * 2;  // one of Q, dO, O
  static constexpr int KV_BYTES = BLOCK_N * D * 2;    // one of K, V
  static constexpr int OFF_DO = ROWS_BYTES;
  static constexpr int OFF_O = 2 * ROWS_BYTES;
  static constexpr int OFF_K = 3 * ROWS_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_ROWS = OFF_V + STAGES * KV_BYTES;  // lse, qseg
  static constexpr int OFF_KSEG = OFF_ROWS + 2 * BLOCK_M * 4;
  static constexpr int OFF_BAR = OFF_KSEG + STAGES * BLOCK_N * 4;
  static constexpr int SMEM = OFF_BAR + (2 * STAGES + 1) * 8 + 1024;
};

// dS of a tile that needs masks, with selects (no per-element branches):
// pairs past Lq or Lk give 0, masked pairs (causal, or segments when SEG)
// take an additive -1e30 * log2(e) before the exponential.
template <bool SEG>
__device__ __forceinline__ void masked_ds(const float (&s)[32],
                                          float (&dp)[32], const Params& p,
                                          int k0, int t, const int (&row)[2],
                                          const int (&qs)[2],
                                          const float (&lse2)[2],
                                          const float (&di)[2],
                                          const int* tKseg) {
  const bool causal = p.causal != 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    const int cl = (i >> 2) * 8 + 2 * t + (i & 1);
    const int key = k0 + cl;
    bool ok = !causal | (key <= row[r]);
    if (SEG) ok = ok & (qs[r] == tKseg[cl]) & (qs[r] >= 0);
    const float val = s[i] * p.scale_log2 + (ok ? 0.f : MASK2);
    const bool in = (row[r] < p.Lq) & (key < p.Lk);
    const float pv = in ? ex2(val - lse2[r]) : 0.f;
    dp[i] = pv * (dp[i] - di[r]) * p.scale;
  }
}

template <int D>
__global__ void __launch_bounds__(Config<D>::THREADS, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_o,
                        const __grid_constant__ CUtensorMap map_do,
                        const Params p) {
  using C = Config<D>;
  constexpr int NB = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem;
  unsigned char* sDO = smem + C::OFF_DO;
  unsigned char* sO = smem + C::OFF_O;
  unsigned char* sK = smem + C::OFF_K;
  unsigned char* sV = smem + C::OFF_V;
  float* sLse = reinterpret_cast<float*>(smem + C::OFF_ROWS);
  int* sQseg = reinterpret_cast<int*>(sLse + C::BLOCK_M);
  int* sKseg = reinterpret_cast<int*>(smem + C::OFF_KSEG);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* empty = full + C::STAGES;
  uint64_t* bar_q = empty + C::STAGES;

  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  const int q0 = blockIdx.y * C::BLOCK_M;
  const int tid = threadIdx.x;
  const long long bh_row = (static_cast<long long>(b) * p.H + h) * p.Lq;

  int n_tiles = (p.Lk + BLOCK_N - 1) / BLOCK_N;
  if (p.causal) {
    // skip key tiles that start past this query tile's last row
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
    mbar_init(bar_q, 1 + 32);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= C::CONSUMERS * 128) {
    // ---- producer warp ----
    const int lane = tid & 31;
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_q, 3 * C::ROWS_BYTES);
      tma_load_rows<D>(sQ, &map_q, bar_q, C::BLOCK_M, h, q0, b);
      tma_load_rows<D>(sDO, &map_do, bar_q, C::BLOCK_M, h, q0, b);
      tma_load_rows<D>(sO, &map_o, bar_q, C::BLOCK_M, h, q0, b);
    }
    // LSE and query segment ids of the block's rows (zeros past Lq)
#pragma unroll
    for (int i = lane; i < C::BLOCK_M; i += 32) {
      const bool in = q0 + i < p.Lq;
      cp_async_4(sLse + i, p.lse + (in ? bh_row + q0 + i : 0), in);
      if (p.qseg != nullptr) {
        cp_async_4(sQseg + i, p.qseg + (in ? b * p.Lq + q0 + i : 0), in);
      }
    }
    cp_async_arrive(bar_q);
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int stage = kt % C::STAGES;
      const int k0 = kt * BLOCK_N;
      mbar_wait(&empty[stage], ((kt / C::STAGES) & 1) ^ 1);
      TRACE_IF(lane == 0 && kt < 6, 46 + kt);
      if (p.kseg != nullptr) {
        // the tile's key segment ids (zeros past Lk, where dS is 0)
#pragma unroll
        for (int i = lane; i < BLOCK_N; i += 32) {
          const bool in = k0 + i < p.Lk;
          cp_async_4(sKseg + stage * BLOCK_N + i,
                     p.kseg + (in ? b * p.Lk + k0 + i : 0), in);
        }
      }
      cp_async_arrive(&full[stage]);
      if (lane == 0) {
        TRACE_IF(kt < 6, 40 + kt);
        mbar_arrive_expect_tx(&full[stage], 2 * C::KV_BYTES);
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
    const int g = lane >> 2;
    const int t = lane & 3;
    const int lr = wg * 64 + warp * 16 + g;  // local index of the first row
    // this thread's two query rows
    const int row[2] = {q0 + lr, q0 + lr + 8};

    float dq[NB][32];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int i = 0; i < 32; ++i) dq[nb][i] = 0.f;
    }

    mbar_wait(bar_q, 0);
    TRACE_IF(tid == 0, 1);

    // di = rowsum(O * dO) in fp32 from the swizzled tiles: the four threads
    // of a row group each sum every fourth 16-byte chunk of the two rows
    float di[2], lse2[2];
    int qs[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int l = lr + 8 * r;
      float acc = 0.f;
#pragma unroll
      for (int c = t; c < D / 8; c += 4) {
        const int off = (c / 8) * C::BLOCK_M * ROW_BYTES + l * ROW_BYTES +
                        (((c % 8) ^ (l & 7)) * 16);
        const uint4 ov = *reinterpret_cast<const uint4*>(sO + off);
        const uint4 dv = *reinterpret_cast<const uint4*>(sDO + off);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]);
          const float2 df = __bfloat1622float2(d2[e]);
          acc += of.x * df.x + of.y * df.y;
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      di[r] = acc;
      lse2[r] = sLse[l] * LOG2E;
      qs[r] = p.qseg != nullptr ? sQseg[l] : 0;
      if (t == 0 && row[r] < p.Lq) p.di[bh_row + row[r]] = acc;
    }
    TRACE_IF(tid == 0, 39);

    for (int kt = 0; kt < n_tiles; ++kt) {
      const int stage = kt % C::STAGES;
      const int k0 = kt * BLOCK_N;
      const unsigned char* tK = sK + stage * C::KV_BYTES;
      const unsigned char* tV = sV + stage * C::KV_BYTES;
      const int* tKseg = sKseg + stage * BLOCK_N;
      mbar_wait(&full[stage], (kt / C::STAGES) & 1);
      TRACE_IF(tid == 0 && kt < 6, 2 + 6 * kt);

      // S = Q K^T and dP = dO V^T for this warpgroup's 64 queries
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        wgmma_ss_64x64<0>(s, desc_kmajor(sQ, C::BLOCK_M, wg * 64, kc),
                          desc_kmajor(tK, BLOCK_N, 0, kc), kc > 0);
      }
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        wgmma_ss_64x64<0>(dp, desc_kmajor(sDO, C::BLOCK_M, wg * 64, kc),
                          desc_kmajor(tV, BLOCK_N, 0, kc), kc > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_acc(s);
      fence_acc(dp);
      TRACE_IF(tid == 0 && kt < 6, 3 + 6 * kt);

      // dS into dp
      if (p.causal || p.qseg != nullptr || k0 + BLOCK_N > p.Lk) {
        if (p.qseg != nullptr) {
          masked_ds<true>(s, dp, p, k0, t, row, qs, lse2, di, tKseg);
        } else {
          masked_ds<false>(s, dp, p, k0, t, row, qs, lse2, di, tKseg);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1;
          const float pv = ex2(s[i] * p.scale_log2 - lse2[r]);
          dp[i] = pv * (dp[i] - di[r]) * p.scale;
        }
      }
      uint32_t da[BLOCK_N / 16][4];
#pragma unroll
      for (int kk = 0; kk < BLOCK_N / 16; ++kk) acc_to_a(da[kk], dp, kk);

      TRACE_IF(tid == 0 && kt < 6, 4 + 6 * kt);
      // dQ += dS K
      wgmma_fence();
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
          wgmma_rs_64x64<1>(dq[nb], da[kk], desc_mnmajor(tK, BLOCK_N, nb, kk),
                            1);
        }
      }
      wgmma_commit();
      TRACE_IF(tid == 0 && kt < 6, 5 + 6 * kt);
      wgmma_wait0();
      TRACE_IF(tid == 0 && kt < 6, 6 + 6 * kt);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) fence_acc(dq[nb]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      TRACE_IF(tid == 0 && kt < 6, 7 + 6 * kt);
    }

    __nv_bfloat16* dqb = p.dq + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= p.Lq) continue;
      __nv_bfloat16* dqrow = dqb + row[r] * p.dq_sl + 2 * t;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          *reinterpret_cast<uint32_t*>(dqrow + nb * 64 + j * 8) =
              pack_bf16x2(dq[nb][4 * j + 2 * r], dq[nb][4 * j + 2 * r + 1]);
        }
      }
    }
    TRACE_IF(tid == 0, 62);
  }
}

// Encode the five tensor maps (q, dO and o in boxes of the block's rows, k
// and v in 64-row boxes) and launch on `stream`. `strides` as in
// flash_bwd_dq_bf16.
template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const long long* strides, int batch,
                   const Params& p, cudaStream_t stream) {
  using C = Config<D>;
  const long long* sq = strides;
  const long long* sk = strides + 3;
  const long long* sv = strides + 6;
  const long long* so = strides + 9;
  const long long* sdo = strides + 12;
  CUtensorMap mq, mk, mv, mo, mdo;
  cudaError_t err = encode_bhld(&mq, q, batch, p.Lq, p.H, D, sq[0], sq[1],
                                sq[2], C::BLOCK_M);
  if (err == cudaSuccess) {
    err = encode_bhld(&mk, k, batch, p.Lk, p.H, D, sk[0], sk[1], sk[2],
                      BLOCK_N);
  }
  if (err == cudaSuccess) {
    err = encode_bhld(&mv, v, batch, p.Lk, p.H, D, sv[0], sv[1], sv[2],
                      BLOCK_N);
  }
  if (err == cudaSuccess) {
    err = encode_bhld(&mo, o, batch, p.Lq, p.H, D, so[0], so[1], so[2],
                      C::BLOCK_M);
  }
  if (err == cudaSuccess) {
    err = encode_bhld(&mdo, dout, batch, p.Lq, p.H, D, sdo[0], sdo[1],
                      sdo[2], C::BLOCK_M);
  }
  if (err != cudaSuccess) return err;
  static unsigned long long smem_set = 0;
  err = set_smem_once(flash_bwd_dq_kernel<D>, C::SMEM, &smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * p.H, (p.Lq + C::BLOCK_M - 1) / C::BLOCK_M);
  flash_bwd_dq_kernel<D><<<grid, C::THREADS, C::SMEM, stream>>>(
      mq, mk, mv, mo, mdo, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success). Shapes, strides and types are
// checked by the Python wrapper; head_dim must be 64 or 128. `strides`
// holds (batch, row, head) strides, in elements, of q, k, v, o, dout, dq,
// dk, dv in that order (dk and dv are not read). flash_bwd_dq_bf16 writes
// di and dq; it must run before flash_bwd_dkv_bf16 (flash_bwd_dkv.cu),
// which reads di.
int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const void* lse,
                      void* di, void* dq, const void* qseg, const void* kseg,
                      int batch, int heads, int lq, int lk, int head_dim,
                      const long long* strides, float scale, int causal,
                      void* stream) {
  if (head_dim != 64 && head_dim != 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long* sdq = strides + 15;
  Params p;
  p.lse = static_cast<const float*>(lse);
  p.di = static_cast<float*>(di);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.H = heads;
  p.Lq = lq;
  p.Lk = lk;
  p.dq_sb = sdq[0]; p.dq_sl = sdq[1]; p.dq_sh = sdq[2];
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) {
    return static_cast<int>(
        launch<64>(q, k, v, o, dout, strides, batch, p, s));
  }
  return static_cast<int>(launch<128>(q, k, v, o, dout, strides, batch, p, s));
}

const char* flash_bwd_dq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
