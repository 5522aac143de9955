// Fused prologue + per-row dynamic int8 quantization, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
//   unidisc_tpu/ops/fused_qmm.py:97  _kernel  (fused_qmm, call :216)
//
// For each row x of an (M, K) activation matrix (bf16 or fp32), in fp32:
//
//   prologue:  mode 1 (adaln_norm): layernorm (mean, then the two-pass
//                variance mean((x - mu)^2), eps 1e-5) or RMS (eps 1e-6),
//                times norm_w; with conditioning, the modality-gated adaLN
//                y (1 + scale[b] m) + shift[b] m, where b = row /
//                rows_per_batch and m = modality[row] (1 when absent);
//              mode 2 (gelu): 0.5 x (1 + tanh(c (x + 0.044715 x^3)));
//              mode 0: identity;
//   quantize:  s = amax(|y|) * (1/127) (1 where amax = 0), and
//              q = round_half_even(y * (1/s)) as int8.
//
// Writes q (M, K) int8 and s (M) fp32. The int8 product that follows is
// int8_matmul.cu. Every multiply and add is a round-to-nearest intrinsic,
// so nvcc contracts nothing into an FMA and the arithmetic is the one
// written in the JAX oracle (fused_qmm.py:61-94); only the order of the
// fp32 row sums differs from XLA's, which can move a value that sits on a
// rounding boundary by one int8 step. Built without --use_fast_math.
//
// Design: one warp per row, 4 rows per block of 128 threads. A row is read
// once from device memory; the passes (mean, variance, amax, quantize)
// re-read it from L1. Unlike the TPU kernel there is no tile constraint:
// any M, any K, any rows_per_batch.
//
// Bound: at the main path's shape (M 6144, K 768, bf16 in) it moves 9.4 MB
// in and 4.7 MB out, 4.2 us at 3.35 TB/s, and does ~20 fp32 operations per
// element: bound by bytes.
//
// What this simple design leaves on the table: 2-byte scalar loads (no
// 16-byte vector loads); the per-row passes are serial within a warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 4;                 // rows (warps) per block
constexpr int THREADS = 32 * ROWS;
constexpr float INV127 = 1.0f / 127.0f;
constexpr float GELU_C = 0.7978845608028654f;  // sqrt(2 / pi)

enum Mode { kNone = 0, kAdalnNorm = 1, kGelu = 2 };
enum NormType { kLayerNorm = 0, kRms = 1 };

struct Params {
  const void* x;         // (M, K) bf16 or fp32
  const float* norm_w;   // (K) or nullptr
  const void* shift;     // (B, K) rows cond_stride apart, or nullptr
  const void* scale;
  const float* modality;  // (M) or nullptr (= all ones)
  int8_t* q;             // (M, K)
  float* s;              // (M)
  long long cond_stride;
  int M, K, rows_per_batch, mode, norm_type;
};

__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(float v) { return v; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

template <typename TX, typename TC>
__global__ void __launch_bounds__(THREADS) fused_qmm_kernel(const Params p) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS + (threadIdx.x >> 5);
  if (row >= p.M) return;
  const TX* x = static_cast<const TX*>(p.x) + static_cast<long long>(row) * p.K;
  const float kf = static_cast<float>(p.K);

  float mu = 0.0f, rs = 1.0f;
  if (p.mode == kAdalnNorm) {
    if (p.norm_type == kLayerNorm) {
      float sum = 0.0f;
      for (int j = lane; j < p.K; j += 32) sum = __fadd_rn(sum, to_float(x[j]));
      mu = __fdiv_rn(warp_sum(sum), kf);
      float sq = 0.0f;
      for (int j = lane; j < p.K; j += 32) {
        const float d = __fsub_rn(to_float(x[j]), mu);
        sq = __fadd_rn(sq, __fmul_rn(d, d));
      }
      const float var = __fdiv_rn(warp_sum(sq), kf);
      rs = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, 1e-5f)));
    } else {
      float sq = 0.0f;
      for (int j = lane; j < p.K; j += 32) {
        const float v = to_float(x[j]);
        sq = __fadd_rn(sq, __fmul_rn(v, v));
      }
      const float ms = __fdiv_rn(warp_sum(sq), kf);
      rs = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(ms, 1e-6f)));
    }
  }
  const bool cond = p.shift != nullptr;
  const long long cond_off = cond
      ? static_cast<long long>(row / p.rows_per_batch) * p.cond_stride : 0;
  const TC* sh = cond ? static_cast<const TC*>(p.shift) + cond_off : nullptr;
  const TC* sc = cond ? static_cast<const TC*>(p.scale) + cond_off : nullptr;
  const float m = p.modality != nullptr ? p.modality[row] : 1.0f;

  auto prologue = [&](int j) -> float {
    const float v = to_float(x[j]);
    if (p.mode == kAdalnNorm) {
      float y = p.norm_type == kLayerNorm ? __fmul_rn(__fsub_rn(v, mu), rs)
                                          : __fmul_rn(v, rs);
      y = __fmul_rn(y, p.norm_w[j]);
      if (cond) {
        y = __fadd_rn(
            __fmul_rn(y, __fadd_rn(1.0f, __fmul_rn(to_float(sc[j]), m))),
            __fmul_rn(to_float(sh[j]), m));
      }
      return y;
    }
    if (p.mode == kGelu) {
      const float x3 = __fmul_rn(__fmul_rn(v, v), v);
      const float inner =
          __fmul_rn(GELU_C, __fadd_rn(v, __fmul_rn(0.044715f, x3)));
      return __fmul_rn(__fmul_rn(0.5f, v), __fadd_rn(1.0f, tanhf(inner)));
    }
    return v;
  };

  float amax = 0.0f;
  for (int j = lane; j < p.K; j += 32) amax = fmaxf(amax, fabsf(prologue(j)));
  amax = warp_max(amax);
  const float s = amax > 0.0f ? __fmul_rn(amax, INV127) : 1.0f;
  const float inv = __fdiv_rn(1.0f, s);
  int8_t* q = p.q + static_cast<long long>(row) * p.K;
  for (int j = lane; j < p.K; j += 32) {
    q[j] = static_cast<int8_t>(static_cast<int>(rintf(__fmul_rn(prologue(j), inv))));
  }
  if (lane == 0) p.s[row] = s;
}

template <typename TX, typename TC>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.M + ROWS - 1) / ROWS);
  fused_qmm_kernel<TX, TC><<<grid, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success). Shapes and dtypes are checked by
// the Python wrapper. x_bf16 / cond_bf16 select bf16 (1) or fp32 (0)
// activations and conditioning rows.
int fused_qmm(const void* x, const void* norm_w, const void* shift,
              const void* scale, const void* modality, void* q, void* s,
              long long cond_stride, int M, int K, int rows_per_batch,
              int mode, int norm_type, int x_bf16, int cond_bf16,
              void* stream) {
  Params p;
  p.x = x;
  p.norm_w = static_cast<const float*>(norm_w);
  p.shift = shift;
  p.scale = scale;
  p.modality = static_cast<const float*>(modality);
  p.q = static_cast<int8_t*>(q);
  p.s = static_cast<float*>(s);
  p.cond_stride = cond_stride;
  p.M = M;
  p.K = K;
  p.rows_per_batch = rows_per_batch;
  p.mode = mode;
  p.norm_type = norm_type;
  if (M < 1 || K < 1 || rows_per_batch < 1 || mode < kNone || mode > kGelu ||
      (mode == kAdalnNorm && norm_w == nullptr) ||
      (shift == nullptr) != (scale == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return static_cast<int>(cond_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(p, st)
                                      : launch<__nv_bfloat16, float>(p, st));
  }
  return static_cast<int>(cond_bf16 ? launch<float, __nv_bfloat16>(p, st)
                                    : launch<float, float>(p, st));
}

const char* fused_qmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
