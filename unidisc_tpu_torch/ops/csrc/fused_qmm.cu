// Per-row int8 quantization, with a fused prologue, for Hopper (sm_90a).
//
// Two C entries share one row kernel:
//
//   fused_qmm         replaces the JAX package's Pallas TPU kernel
//                       unidisc_tpu/ops/fused_qmm.py:97  _kernel
//                       (fused_qmm, call :216):
//                     a prologue, then the MULTIPLYING rounding form;
//   row_quantize_div  no prologue, the DIVIDING form, in three forms:
//                     the port's kernel for the JAX package's
//                       unidisc_tpu/ops/quant.py:51  dynamic_quantize,
//                     which has no Pallas kernel (XLA fuses it into the
//                     jitted program); and that quantize split in two,
//                     each row's amax(|x|) in fp32 (row_amax) and the
//                     quantize by a per-row amax it is given, not by the
//                     row's own (quantize_by_amax).
//
// The split forms serve a row-parallel int8 product under tensor
// parallelism (ops/quant.py::qdot_row_parallel): a rank holds a K-slice
// of each row, takes its slice's amax, the amaxes are reduced (max) over
// the group, and each rank quantizes its slice by the whole row's amax, so
// its int8 values and scale are those of dynamic_quantize of the whole
// row. They replace no TPU kernel (JAX quantizes whole rows on every
// device). A max is exact in any order, so both equal their plain
// versions bit for bit.
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
//   quantize:  multiplying form: s = amax(|y|) * (1/127), q = rint(y * (1/s));
//              dividing form:    s = amax(|y|) / 127,     q = rint(y / s);
//              s = 1 where amax = 0; rint rounds half to even.
//
// Writes q (M, K) int8 and s (M) fp32. The int8 product that follows is
// int8_matmul.cu. Every multiply, add and divide is a round-to-nearest
// intrinsic, so nvcc contracts nothing into an FMA and the arithmetic is
// the one written in the JAX oracles (fused_qmm.py:61-94, quant.py:51-56).
// The dividing form takes no sum, so it equals its plain version bit for
// bit; its per-element division is a multiply by the reciprocal, which
// rounds as the quotient does wherever it is clear of a half-integer, and
// an exact residual test where it is not (quantize_vec, near_half). In the
// prologue only the order of the fp32 row sums differs from XLA's, which
// can move a value that sits on a rounding boundary by one int8 step.
// Built without --use_fast_math.
//
// Bound: bytes. x is read once, q and s written once (norm_w and the (B, K)
// adaLN rows are a few KB, read from L2). At the int8 serve path's shapes,
// bf16 in, at 3.35 TB/s: fused_qmm (6144, 768) rms + adaLN + modality
// 14.3 MB, 4.26 us; dynamic_quantize (6144, 768) 14.2 MB, 4.23 us,
// (6144, 3072) 56.6 MB, 16.9 us, (2048, 768) 4.7 MB, 1.41 us. The prologue
// is ~15 fp32 operations an element, far under the card's rate. A tensor
// rank's row-parallel inputs at tensor 2, bf16: row_amax (6144, 384)
// 4.7 MB, 1.42 us, (6144, 1536) 18.9 MB, 5.64 us; quantize_by_amax
// 7.1 MB, 2.13 us, and 28.4 MB, 8.47 us.
//
// Design: register-resident rows. LANES lanes hold a row (a warp, or a
// quarter or half warp for narrow rows); each lane issues all of its
// NV 16-byte loads of the row up front (3 at K 768 bf16, 12 at K 3072
// bf16, 6 at K 768 fp32), so a warp keeps the whole row in flight. The row
// stays in registers: the mean, variance or sum of squares and the amax
// are taken from them, each with one shuffle reduction, and the prologue
// runs once an element. norm_w and the shift and scale rows are read as
// 16-byte vectors in the same column order, the modality gate once a row.
// Values are rounded to integers by an add (ROUND_MAGIC), not by the
// conversion instructions, and the dividing form divides nothing an
// element. int8 goes out as one 8-byte store per 8 bf16 (4 bytes per 4
// fp32), so a warp writes contiguous 256-byte runs; the scale once a row.
// The vectors-per-lane count is a template parameter; the wrapper picks it
// (ops/fused_qmm.py row_plan). Any other K, or an operand that is not
// 16-byte aligned, takes the generic loop below: one warp a row, scalar
// loads, the row walked from L1 once per pass. No TMA or wgmma: there is
// no product here.
//
// ptxas -v (nvcc 12.9, sm_90a), 72 instantiations, none spills: at K 768
// bf16, fused_qmm 56 registers (bf16 adaLN rows), dynamic_quantize 60; at
// K 3072 bf16, dynamic_quantize 167 (three blocks an SM); the widest,
// K 4096 bf16, 254-255.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;                // warps per block
constexpr int THREADS = 32 * WARPS;
constexpr float INV127 = 1.0f / 127.0f;
constexpr float GELU_C = 0.7978845608028654f;  // sqrt(2 / pi)

enum Mode { kNone = 0, kAdalnNorm = 1, kGelu = 2 };
enum NormType { kLayerNorm = 0, kRms = 1 };
// kAmax writes the row's amax and quantizes nothing; kGiven is the
// dividing form by the amax in Params::amax
enum Form { kMultiply = 0, kDivide = 1, kAmax = 2, kGiven = 3 };

// the forms that round as the dividing form does
__host__ __device__ constexpr bool divides(int form) {
  return form == kDivide || form == kGiven;
}

struct Params {
  const void* x;         // (M, K) bf16 or fp32
  const float* norm_w;   // (K) or nullptr
  const void* shift;     // (B, K) rows cond_stride apart, or nullptr
  const void* scale;
  const float* modality;  // (M) or nullptr (= all ones)
  int8_t* q;             // (M, K)
  float* s;              // (M): the scales, or kAmax's amaxes
  const float* amax;     // (M): kGiven's amaxes, or nullptr
  long long cond_stride;
  int M, K, rows_per_batch, mode, norm_type;
};

__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(float v) { return v; }

// sum / max over the aligned group of LANES lanes that holds a row
template <int LANES>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

template <int LANES>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

// one 32-bit word of T values as floats (bf16 is the top half of an fp32)
template <typename T>
__device__ __forceinline__ void unpack_word(uint32_t w, float* out);
template <>
__device__ __forceinline__ void unpack_word<__nv_bfloat16>(uint32_t w,
                                                           float* out) {
  out[0] = __uint_as_float(w << 16);
  out[1] = __uint_as_float(w & 0xffff0000u);
}
template <>
__device__ __forceinline__ void unpack_word<float>(uint32_t w, float* out) {
  out[0] = __uint_as_float(w);
}

// N consecutive T values at p as floats: 16-byte loads, or one 8-byte load
// for 8 bytes. p is aligned to the load's width.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  constexpr int WORDS = N * static_cast<int>(sizeof(T)) / 4;
  constexpr int PER_WORD = 4 / static_cast<int>(sizeof(T));
  if constexpr (WORDS % 4 == 0) {
    const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int c = 0; c < WORDS / 4; ++c) {
      const uint4 u = __ldg(v + c);
      unpack_word<T>(u.x, out + (4 * c + 0) * PER_WORD);
      unpack_word<T>(u.y, out + (4 * c + 1) * PER_WORD);
      unpack_word<T>(u.z, out + (4 * c + 2) * PER_WORD);
      unpack_word<T>(u.w, out + (4 * c + 3) * PER_WORD);
    }
  } else {
    static_assert(WORDS == 2, "load_vec: 8 or a multiple of 16 bytes");
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    unpack_word<T>(u.x, out);
    unpack_word<T>(u.y, out + PER_WORD);
  }
}

__device__ __forceinline__ uint32_t pack4(const int* v) {
  return (static_cast<uint32_t>(v[0]) & 0xffu)
       | ((static_cast<uint32_t>(v[1]) & 0xffu) << 8)
       | ((static_cast<uint32_t>(v[2]) & 0xffu) << 16)
       | (static_cast<uint32_t>(v[3]) << 24);
}

// V int8 values (4 or 8) to p in one store
template <int V>
__device__ __forceinline__ void store_q(int8_t* p, const int* v) {
  if constexpr (V == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack4(v), pack4(v + 4));
  } else {
    static_assert(V == 4, "store_q: 4 or 8 values");
    *reinterpret_cast<uint32_t*>(p) = pack4(v);
  }
}

__device__ __forceinline__ float gelu(float v) {
  const float x3 = __fmul_rn(__fmul_rn(v, v), v);
  const float inner = __fmul_rn(GELU_C, __fadd_rn(v, __fmul_rn(0.044715f, x3)));
  return __fmul_rn(__fmul_rn(0.5f, v), __fadd_rn(1.0f, tanhf(inner)));
}

// the modulated, normalised value of one element
__device__ __forceinline__ float adaln(float v, bool layernorm, float mu,
                                       float rs, float w, bool cond, float sh,
                                       float sc, float m) {
  float y = layernorm ? __fmul_rn(__fsub_rn(v, mu), rs) : __fmul_rn(v, rs);
  y = __fmul_rn(y, w);
  if (cond) {
    y = __fadd_rn(__fmul_rn(y, __fadd_rn(1.0f, __fmul_rn(sc, m))),
                  __fmul_rn(sh, m));
  }
  return y;
}

template <int FORM>
__device__ __forceinline__ float row_scale(float amax) {
  if constexpr (!divides(FORM)) {
    return amax > 0.0f ? __fmul_rn(amax, INV127) : 1.0f;
  } else {
    return amax > 0.0f ? __fdiv_rn(amax, 127.0f) : 1.0f;
  }
}

// 1 / s: the multiplying form's reciprocal, and the dividing form's for its
// fast path (both correctly rounded)
__device__ __forceinline__ float row_inverse(float s) { return __frcp_rn(s); }

// rint (half to even) of |t| < 2^22 without the card's conversion
// instructions (16 results a clock an SM, against 128 for an add): t + 1.5
// 2^23 lands where the spacing of floats is 1, so the add rounds t to an
// integer, held in the low bits of the sum, which is ROUND_BITS + rint(t).
constexpr float ROUND_MAGIC = 12582912.0f;  // 1.5 * 2^23
constexpr int ROUND_BITS = 0x4B400000;       // its bits
// the dividing form's fast path holds where t is this far from a
// half-integer: 0.5 - 2^-14
constexpr float CLEAR_OF_HALF = 0.49993896484375f;
// a dividing-form row whose scale is under TINY_SCALE is scaled by
// TINY_LIFT, exactly (y / s is unchanged), so that 1 / s and the residuals
// of near_half stay normal
constexpr float TINY_SCALE = 0x1p-100f;
constexpr float TINY_LIFT = 0x1p64f;

// rint(y / s) for a y whose t = y * (1 / s) lies within 2^-14 of a
// half-integer h = lo + 1/2 (n = rint(t), as an int and a float). Then
// |y / s - h| < 2^-13, so r = y - h s spans at most 13 bits of s's grid and
// the FMA computes it exactly: its sign says on which side of h the
// quotient lies. The quotient rounds to h itself, and then to h's even
// neighbour, where |r| < (ulp(h) / 2) s (exact: a power of two times s); it
// is never exactly a midpoint of floats (a quotient of two floats is not),
// so there is no tie to break. Needs s >= TINY_SCALE.
__device__ __forceinline__ int near_half(float y, float s, float t, int n,
                                         float nf) {
  const bool below = __fsub_rn(t, nf) < 0.0f;
  const int lo = below ? n - 1 : n;
  const float h = below ? __fsub_rn(nf, 0.5f) : __fadd_rn(nf, 0.5f);
  const float r = __fmaf_rn(-h, s, y);
  const float half_ulp =
      __int_as_float((__float_as_int(h) & 0x7f800000) - (24 << 23));
  const bool on_h = fabsf(r) < __fmul_rn(half_ulp, s);
  return lo + ((on_h ? (lo & 1) != 0 : r > 0.0f) ? 1 : 0);
}

// V values of a row quantized in its rounding form into q: s the row's
// scale (lifted for the dividing form, see TINY_SCALE) and inv =
// row_inverse(s).
//
// The dividing form's q = rint(y / s) equals rint(__fdiv_rn(y, s)) without
// a division an element: with |y| <= amax, |y / s| < 128, so t = y * inv
// (two roundings of 2^-24) is within 2^-16 of y / s, and within 2^-15 of
// its rounded quotient (half an ulp, <= 2^-18, below 128). Where t is more
// than 2^-14 from every half-integer, the rounded quotient lies in the same
// interval between half-integers and rounds to the same integer as t. A
// vector with a value nearer than that (about one value in 8,000 of random
// data) goes through near_half.
template <int FORM, int V>
__device__ __forceinline__ void quantize_vec(const float* y, float s,
                                            float inv, int* q) {
  bool clear = true;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float t = __fmul_rn(y[i], inv);
    const float u = __fadd_rn(t, ROUND_MAGIC);
    q[i] = __float_as_int(u) - ROUND_BITS;
    if constexpr (divides(FORM)) {
      clear &= fabsf(__fsub_rn(t, __fsub_rn(u, ROUND_MAGIC))) < CLEAR_OF_HALF;
    }
  }
  if (divides(FORM) && !clear) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float t = __fmul_rn(y[i], inv);
      const float u = __fadd_rn(t, ROUND_MAGIC);
      const float nf = __fsub_rn(u, ROUND_MAGIC);
      if (!(fabsf(__fsub_rn(t, nf)) < CLEAR_OF_HALF)) {
        q[i] = near_half(y[i], s, t, __float_as_int(u) - ROUND_BITS, nf);
      }
    }
  }
}

// the dividing form's lift of a row of tiny scale (1 for the other rows and
// for the multiplying form)
template <int FORM>
__device__ __forceinline__ float tiny_lift(float s) {
  return divides(FORM) && s < TINY_SCALE ? TINY_LIFT : 1.0f;
}

// The register-resident row kernel: LANES lanes a row, NV 16-byte vectors
// a lane, K = NV * LANES * (16 / sizeof(TX)). Lane l of a row holds the
// vectors l, l + LANES, l + 2 LANES, ... of it.
template <typename TX, typename TC, int LANES, int NV, int FORM>
__global__ void __launch_bounds__(THREADS) row_kernel(const Params p) {
  constexpr int V = 16 / static_cast<int>(sizeof(TX));  // values a vector
  constexpr int E = NV * V;                             // values a lane
  constexpr int K = NV * LANES * V;
  constexpr int ROWS_PER_WARP = 32 / LANES;
  const int lane = threadIdx.x & 31;
  const int sub = lane % LANES;
  const int first = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * ROWS_PER_WARP;
  const int r = first + lane / LANES;
  // a group past the last row works on the last row (every lane takes part
  // in the shuffles) and stores nothing
  const bool valid = r < p.M;
  const int row = valid ? r : p.M - 1;

  const TX* x = static_cast<const TX*>(p.x) + static_cast<long long>(row) * K;
  float y[E];
#pragma unroll
  for (int v = 0; v < NV; ++v) load_vec<TX, V>(x + (v * LANES + sub) * V, y + v * V);

  // the dividing form (dynamic_quantize) has no prologue
  if (FORM == kMultiply && p.mode == kAdalnNorm) {
    const bool layernorm = p.norm_type == kLayerNorm;
    float mu = 0.0f, rs;
    if (layernorm) {
      float sum = 0.0f;
#pragma unroll
      for (int e = 0; e < E; ++e) sum = __fadd_rn(sum, y[e]);
      mu = __fdiv_rn(group_sum<LANES>(sum), static_cast<float>(K));
      float sq = 0.0f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float d = __fsub_rn(y[e], mu);
        sq = __fadd_rn(sq, __fmul_rn(d, d));
      }
      const float var = __fdiv_rn(group_sum<LANES>(sq), static_cast<float>(K));
      rs = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, 1e-5f)));
    } else {
      float sq = 0.0f;
#pragma unroll
      for (int e = 0; e < E; ++e) sq = __fadd_rn(sq, __fmul_rn(y[e], y[e]));
      const float ms = __fdiv_rn(group_sum<LANES>(sq), static_cast<float>(K));
      rs = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(ms, 1e-6f)));
    }
    const bool cond = p.shift != nullptr;
    const long long cond_off =
        cond ? static_cast<long long>(row / p.rows_per_batch) * p.cond_stride : 0;
    const TC* sh = cond ? static_cast<const TC*>(p.shift) + cond_off : nullptr;
    const TC* sc = cond ? static_cast<const TC*>(p.scale) + cond_off : nullptr;
    const float m = p.modality != nullptr ? p.modality[row] : 1.0f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int col = (v * LANES + sub) * V;
      float w[V], shv[V], scv[V];
      load_vec<float, V>(p.norm_w + col, w);
      if (cond) {
        load_vec<TC, V>(sh + col, shv);
        load_vec<TC, V>(sc + col, scv);
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        y[v * V + i] = adaln(y[v * V + i], layernorm, mu, rs, w[i], cond,
                             cond ? shv[i] : 0.0f, cond ? scv[i] : 0.0f, m);
      }
    }
  } else if (FORM == kMultiply && p.mode == kGelu) {
#pragma unroll
    for (int e = 0; e < E; ++e) y[e] = gelu(y[e]);
  }

  float amax = 0.0f;
  if constexpr (FORM == kGiven) {
    amax = p.amax[row];
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) amax = fmaxf(amax, fabsf(y[e]));
    amax = group_max<LANES>(amax);
  }
  if constexpr (FORM == kAmax) {
    if (valid && sub == 0) p.s[row] = amax;
    return;
  }
  const float s = row_scale<FORM>(amax);
  const float lift = tiny_lift<FORM>(s);
  const float s_lifted = __fmul_rn(s, lift);
  const float inv = row_inverse(s_lifted);
  if (lift != 1.0f) {
#pragma unroll
    for (int e = 0; e < E; ++e) y[e] = __fmul_rn(y[e], lift);
  }
  if (!valid) return;
  int8_t* q = p.q + static_cast<long long>(row) * K;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    int qv[V];
    quantize_vec<FORM, V>(y + v * V, s_lifted, inv, qv);
    store_q<V>(q + (v * LANES + sub) * V, qv);
  }
  if (sub == 0) p.s[row] = s;
}

// The generic loop: one warp a row, any K, any alignment. The row is read
// from device memory once; the passes (mean, variance, amax, quantize)
// re-read it from L1 and apply the prologue where they need it.
template <typename TX, typename TC, int FORM>
__global__ void __launch_bounds__(THREADS) generic_kernel(const Params p) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= p.M) return;
  const TX* x = static_cast<const TX*>(p.x) + static_cast<long long>(row) * p.K;
  const float kf = static_cast<float>(p.K);
  const bool layernorm = p.norm_type == kLayerNorm;

  const int mode = FORM == kMultiply ? p.mode : kNone;
  float mu = 0.0f, rs = 1.0f;
  if (mode == kAdalnNorm) {
    if (layernorm) {
      float sum = 0.0f;
      for (int j = lane; j < p.K; j += 32) sum = __fadd_rn(sum, to_float(x[j]));
      mu = __fdiv_rn(group_sum<32>(sum), kf);
      float sq = 0.0f;
      for (int j = lane; j < p.K; j += 32) {
        const float d = __fsub_rn(to_float(x[j]), mu);
        sq = __fadd_rn(sq, __fmul_rn(d, d));
      }
      const float var = __fdiv_rn(group_sum<32>(sq), kf);
      rs = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, 1e-5f)));
    } else {
      float sq = 0.0f;
      for (int j = lane; j < p.K; j += 32) {
        const float v = to_float(x[j]);
        sq = __fadd_rn(sq, __fmul_rn(v, v));
      }
      const float ms = __fdiv_rn(group_sum<32>(sq), kf);
      rs = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(ms, 1e-6f)));
    }
  }
  const bool cond = p.shift != nullptr;
  const long long cond_off =
      cond ? static_cast<long long>(row / p.rows_per_batch) * p.cond_stride : 0;
  const TC* sh = cond ? static_cast<const TC*>(p.shift) + cond_off : nullptr;
  const TC* sc = cond ? static_cast<const TC*>(p.scale) + cond_off : nullptr;
  const float m = p.modality != nullptr ? p.modality[row] : 1.0f;

  auto prologue = [&](int j) -> float {
    const float v = to_float(x[j]);
    if (mode == kAdalnNorm) {
      return adaln(v, layernorm, mu, rs, p.norm_w[j], cond,
                   cond ? to_float(sh[j]) : 0.0f,
                   cond ? to_float(sc[j]) : 0.0f, m);
    }
    return mode == kGelu ? gelu(v) : v;
  };

  float amax = 0.0f;
  if constexpr (FORM == kGiven) {
    amax = p.amax[row];
  } else {
    for (int j = lane; j < p.K; j += 32) {
      amax = fmaxf(amax, fabsf(prologue(j)));
    }
    amax = group_max<32>(amax);
  }
  if constexpr (FORM == kAmax) {
    if (lane == 0) p.s[row] = amax;
    return;
  }
  const float s = row_scale<FORM>(amax);
  const float lift = tiny_lift<FORM>(s);
  const float s_lifted = __fmul_rn(s, lift);
  const float inv = row_inverse(s_lifted);
  int8_t* q = p.q + static_cast<long long>(row) * p.K;
  for (int j = lane; j < p.K; j += 32) {
    const float y = __fmul_rn(prologue(j), lift);
    int qj;
    quantize_vec<FORM, 1>(&y, s_lifted, inv, &qj);
    q[j] = static_cast<int8_t>(qj);
  }
  if (lane == 0) p.s[row] = s;
}

template <typename TX, typename TC, int LANES, int NV, int FORM>
cudaError_t launch_rows(const Params& p, cudaStream_t stream) {
  if (p.K != NV * LANES * (16 / static_cast<int>(sizeof(TX)))) {
    return cudaErrorInvalidValue;
  }
  constexpr int ROWS = WARPS * (32 / LANES);
  const dim3 grid((p.M + ROWS - 1) / ROWS);
  row_kernel<TX, TC, LANES, NV, FORM><<<grid, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

// (lanes, nv) as the wrapper's row_plan gives them; (32, 0) is the generic
// loop
template <typename TX, typename TC, int FORM>
cudaError_t launch(const Params& p, int lanes, int nv, cudaStream_t stream) {
  switch (lanes * 100 + nv) {
    case 3200: {
      const dim3 grid((p.M + WARPS - 1) / WARPS);
      generic_kernel<TX, TC, FORM><<<grid, THREADS, 0, stream>>>(p);
      return cudaGetLastError();
    }
    case 801: return launch_rows<TX, TC, 8, 1, FORM>(p, stream);
    case 1601: return launch_rows<TX, TC, 16, 1, FORM>(p, stream);
    case 3201: return launch_rows<TX, TC, 32, 1, FORM>(p, stream);
    case 3202: return launch_rows<TX, TC, 32, 2, FORM>(p, stream);
    case 3203: return launch_rows<TX, TC, 32, 3, FORM>(p, stream);
    case 3204: return launch_rows<TX, TC, 32, 4, FORM>(p, stream);
    case 3205: return launch_rows<TX, TC, 32, 5, FORM>(p, stream);
    case 3206: return launch_rows<TX, TC, 32, 6, FORM>(p, stream);
    case 3208: return launch_rows<TX, TC, 32, 8, FORM>(p, stream);
    case 3212: return launch_rows<TX, TC, 32, 12, FORM>(p, stream);
    case 3216: return launch_rows<TX, TC, 32, 16, FORM>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success). Shapes, dtypes and alignment are
// checked by the Python wrapper. x_bf16 / cond_bf16 select bf16 (1) or
// fp32 (0) activations and conditioning rows; (lanes, nv) the row kernel's
// width, or (32, 0) for the generic loop.
int fused_qmm(const void* x, const void* norm_w, const void* shift,
              const void* scale, const void* modality, void* q, void* s,
              long long cond_stride, int M, int K, int rows_per_batch,
              int mode, int norm_type, int lanes, int nv, int x_bf16,
              int cond_bf16, void* stream) {
  Params p = {};
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
  cudaError_t err;
  if (x_bf16) {
    err = cond_bf16 ? launch<__nv_bfloat16, __nv_bfloat16, kMultiply>(p, lanes, nv, st)
                    : launch<__nv_bfloat16, float, kMultiply>(p, lanes, nv, st);
  } else {
    err = cond_bf16 ? launch<float, __nv_bfloat16, kMultiply>(p, lanes, nv, st)
                    : launch<float, float, kMultiply>(p, lanes, nv, st);
  }
  return static_cast<int>(err);
}

// The dividing form's entry, no prologue: x (M, K) bf16 or fp32, by
// `form`:
//   kDivide  dynamic_quantize: q (M, K) int8 and s (M) fp32, s = amax /
//            127 of each row's own amax (1 where it is 0), q = rint(x / s);
//            amax unread;
//   kAmax    row_amax: s (M) fp32 = each row's amax(|x|); q unwritten;
//   kGiven   as kDivide, by the amax (M) fp32 given, at least each row's
//            own (a tensor rank's K-slice by the whole row's amax).
int row_quantize_div(const void* x, const void* amax, void* q, void* s, int M,
                     int K, int lanes, int nv, int x_bf16, int form,
                     void* stream) {
  Params p = {};
  p.x = x;
  p.amax = static_cast<const float*>(amax);
  p.q = static_cast<int8_t*>(q);
  p.s = static_cast<float*>(s);
  p.M = M;
  p.K = K;
  p.rows_per_batch = 1;
  p.mode = kNone;
  p.norm_type = kLayerNorm;
  if (M < 1 || K < 1 || s == nullptr || (form == kGiven) != (amax != nullptr)
      || (form != kAmax && q == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (form) {
    case kDivide:
      err = x_bf16 ? launch<__nv_bfloat16, __nv_bfloat16, kDivide>(p, lanes, nv, st)
                   : launch<float, float, kDivide>(p, lanes, nv, st);
      break;
    case kAmax:
      err = x_bf16 ? launch<__nv_bfloat16, __nv_bfloat16, kAmax>(p, lanes, nv, st)
                   : launch<float, float, kAmax>(p, lanes, nv, st);
      break;
    case kGiven:
      err = x_bf16 ? launch<__nv_bfloat16, __nv_bfloat16, kGiven>(p, lanes, nv, st)
                   : launch<float, float, kGiven>(p, lanes, nv, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* fused_qmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
