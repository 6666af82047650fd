// Native (host) eXmY numerics of the PyTorch port: its own copy of
// cpd_tpu/native/quant_native.cpp, the C++ counterpart of the reference's
// native layer (reference: CPDtorch/quant/quant_cuda/).  The device
// kernels are CUDA (cpd_tpu_torch/csrc/); this library serves the host:
//
//   * data-pipeline quantization (quantize training inputs / gradients on
//     host without a device round-trip),
//   * an independent, third implementation of the cast semantics used as a
//     cross-oracle in tests (jnp bit-twiddle vs NumPy transliteration vs
//     this), and
//   * host-side reference reductions for validating collectives.
//
// Semantics are the documented contract of cpd_tpu_torch/quant/numerics.py
// (which mirrors float_kernel.cu:10-92 with its two UB deviations
// defined): RTNE at 23-man_bits, custom subnormals via truncating
// right-shift then RTNE, pre-rounding saturation to +/-Inf, FP32
// subnormal inputs flush to +0, Inf/NaN/+-0 passthrough.
//
// Build: g++ -O2 -shared -fPIC -pthread -ffp-contract=off at first use
// (cpd_tpu_torch/native/__init__.py); -ffp-contract=off keeps every
// product and sum its own IEEE operation on any x86 or ARM host.

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

inline uint32_t bits_of(float f) {
  uint32_t u;
  std::memcpy(&u, &f, sizeof(u));
  return u;
}

inline float float_of(uint32_t u) {
  float f;
  std::memcpy(&f, &u, sizeof(f));
  return f;
}

// Round-to-nearest-even of an integer significand at bit `shift`.
inline uint32_t rtne(uint32_t man, int shift) {
  if (shift <= 0) return man;
  const uint32_t half = 1u << (shift - 1);
  const uint32_t sticky_mask = half - 1u;
  const uint32_t keep_mask = ~((1u << shift) - 1u);
  const bool round_bit = (man & half) != 0;
  const bool sticky = (man & sticky_mask) != 0;
  const bool lsb = (man & (1u << shift)) != 0;
  if (round_bit && (sticky || lsb)) man += half;
  return man & keep_mask;
}

float cast_one(float x, int exp_bits, int man_bits) {
  const uint32_t u = bits_of(x);
  const int exp_f = (u >> 23) & 0xFF;
  const uint32_t man_f = u & 0x007FFFFFu;
  const bool negative = (u >> 31) != 0;

  if (exp_f == 0xFF || (exp_f == 0 && man_f == 0)) return x;  // Inf/NaN/+-0
  if (exp_f == 0) return 0.0f;  // FP32 subnormal input flushes to +0

  const int bias = (1 << (exp_bits - 1)) - 1;
  uint32_t man24 = man_f | (1u << 23);
  const int new_e = exp_f - 127 + bias;

  // Pre-rounding saturation (mantissa round-up past max still carries
  // into the exponent instead of saturating — deliberate, see
  // numerics.py docstring).
  if (new_e >= (1 << exp_bits) - 1) {
    return negative ? -INFINITY : INFINITY;
  }

  const int shift = 23 - man_bits;
  uint32_t man_out;
  int e_out;
  if (new_e > 0) {                      // normal target
    man_out = rtne(man24, shift);
    e_out = exp_f - 127;
  } else {                              // subnormal target
    int sub_shift = 1 - new_e;
    if (sub_shift > 24) sub_shift = 24;   // man24 < 2^24
    man24 >>= sub_shift;                  // truncating (double-round quirk)
    // man_bits == 23 => no rounding (deviation 1: defined, not UB)
    man_out = (man_bits == 23) ? man24 : rtne(man24, shift);
    e_out = 1 - bias;
  }

  // man * 2^(e-23); ldexpf is exact here (result is k * 2^(e-23) with
  // k < 2^25, representable whenever e-23 >= -149; below that the true
  // value rounds to 0 identically in both implementations).
  float mag = std::ldexp(static_cast<float>(man_out), e_out - 23);
  return negative ? -mag : mag;
}

}  // namespace

extern "C" {

float cpd_cast_one(float x, int exp_bits, int man_bits) {
  return cast_one(x, exp_bits, man_bits);
}

// Elementwise quantize (reference float_kernel_nearest, float_kernel.cu:
// 94-101; pure here: in/out may alias but need not).
void cpd_quantize(const float* in, float* out, int64_t n, int exp_bits,
                  int man_bits) {
  for (int64_t i = 0; i < n; ++i) out[i] = cast_one(in[i], exp_bits, man_bits);
}

// GEMM out = a(M,K) @ b(K,N) with eXmY Kahan accumulator: the faithful
// recipe of quant_function.qgemm (tmp/y/t/c all re-cast, K visited in
// ascending order; a zero-initialized residual: the reference edge
// path's uninitialized residual is UB, not semantics).
void cpd_qgemm(const float* a, const float* b, float* out, int64_t M,
               int64_t N, int64_t K, int exp_bits, int man_bits) {
  for (int64_t i = 0; i < M; ++i) {
    for (int64_t j = 0; j < N; ++j) {
      float s = 0.0f, c = 0.0f;
      for (int64_t k = 0; k < K; ++k) {
        const float tmp = cast_one(a[i * K + k] * b[k * N + j], exp_bits,
                                   man_bits);
        const float y = cast_one(tmp - c, exp_bits, man_bits);
        const float t = cast_one(s + y, exp_bits, man_bits);
        c = cast_one(cast_one(t - s, exp_bits, man_bits) - y, exp_bits,
                     man_bits);
        s = t;
      }
      out[i * N + j] = s;
    }
  }
}

// Ordered quantized reduction over the leading axis of stacked (W, n):
// res = q(res + g_r) in rank order (parallel/reduction.py's ordered
// quantized sum; reference dist_util.py:60-69), or the Kahan
// variant (dist_util.py:72-89) when kahan != 0.
void cpd_ordered_sum(const float* stacked, float* out, int64_t W, int64_t n,
                     int exp_bits, int man_bits, int kahan) {
  if (kahan) {
    for (int64_t i = 0; i < n; ++i) {
      float res = 0.0f, c = 0.0f;
      for (int64_t r = 0; r < W; ++r) {
        const float g = stacked[r * n + i];
        const float y = cast_one(g - c, exp_bits, man_bits);
        const float t = cast_one(res + y, exp_bits, man_bits);
        c = cast_one(cast_one(t - res, exp_bits, man_bits) - y, exp_bits,
                     man_bits);
        res = t;
      }
      out[i] = res;
    }
  } else {
    for (int64_t i = 0; i < n; ++i) {
      float res = 0.0f;
      for (int64_t r = 0; r < W; ++r) {
        res = cast_one(res + stacked[r * n + i], exp_bits, man_bits);
      }
      out[i] = res;
    }
  }
}

}  // extern "C"
