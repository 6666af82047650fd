// Per-element eXmY bodies shared by the port's quantize kernels.
//
// Each function is the CUDA transcription of one function of
// cpd_tpu_torch/quant/numerics.py (itself bitwise the JAX package's
// cpd_tpu/quant/numerics.py), over the fp32 bit pattern as uint32/int:
//   * cast          -- cast_body (RTNE): Inf/NaN/±0 pass through, fp32
//                      subnormal inputs flush to +0.0, exponent overflow
//                      saturates to ±Inf BEFORE rounding, a value that
//                      only rounds past the max carries to 2^(emax+1),
//                      subnormal targets take a truncating pre-shift
//                      and then the same rounding;
//   * cast_sr       -- cast_body_sr: the same cast with the SR step
//                      (both are cast_with, templated on the rounding,
//                      as numerics._cast_core takes a round_fn);
//   * cast_fadd     -- cast_body again, for eb <= 7 and mb <= 21, with
//                      per-format constants (CastBits) computed on the
//                      host: the fp32 adder's own alignment and rounding
//                      (K8's inner loop);
//   * sr_bits_at    -- prng.sr_bits_at: two threefry2x32 evaluations;
//   * pack_code     -- pack_code: a cast output -> its code word;
//   * unpack_code   -- unpack_code: a code word -> the cast's fp32 bits;
//   * flush_low, frexp_exp, scale_pow2, max_finite, format_max_exponent
//                   -- the block-scaled codec's helpers (_flush_low, the
//                      exponent torch.frexp returns, _scale_pow2, ...);
//   * fletcher_mod65521 -- x mod 65521, the digests' modulus.
// Every float operation is __fmul_rn/__fadd_rn (no FMA contraction) and
// every power of two is assembled from bits, so the card computes the
// same bits as the plain version.  The source is built without
// --use_fast_math: with -ftz=true the card would flush subnormal INPUTS
// before the body sees them.  Hopper's FP8 conversions round and
// saturate differently and are never used here.

#pragma once

#include <stdint.h>

namespace exmy {

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// exact fp32 2^e for integer e in [-126, 127] (numerics._pow2)
__device__ __forceinline__ float pow2i(int e) {
  return __int_as_float((e + 127) << 23);
}

// round-to-nearest-even of an integer significand at bit `shift`
// (numerics._rtne); man < 2^24, so nothing here overflows an int
__device__ __forceinline__ int rtne(int man, int shift) {
  if (shift <= 0) return man;
  const int half = 1 << (shift - 1);
  const bool round_bit = (man & half) != 0;
  const bool sticky = (man & (half - 1)) != 0;
  const bool lsb = (man & (1 << shift)) != 0;
  if (round_bit && (sticky || lsb)) man += half;
  return man & ~((1 << shift) - 1);
}

// stochastic rounding at bit `shift` (numerics._sr): add the low `shift`
// bits of r and truncate; man + r < 2^24 + 2^23, still an int
__device__ __forceinline__ int sr(int man, int shift, uint32_t r) {
  if (shift <= 0) return man;
  const int mask = (1 << shift) - 1;
  return (man + int(r & uint32_t(mask))) & ~mask;
}

// the rounding step of a cast, as numerics._cast_core's round_fn
struct Rtne {
  __device__ __forceinline__ int operator()(int man, int shift) const {
    return rtne(man, shift);
  }
};
struct Sr {
  uint32_t r;
  __device__ __forceinline__ int operator()(int man, int shift) const {
    return sr(man, shift, r);
  }
};

// numerics._cast_core: the cast of x into the (eb, mb) value set with the
// rounding step `round`, which both significands (normal and subnormal
// target) go through
template <class Round>
__device__ __forceinline__ float cast_with(float x, int eb, int mb,
                                           Round round) {
  const uint32_t bits = __float_as_uint(x);
  const int exp_f = int((bits >> 23) & 0xFFu);
  const int man_f = int(bits & 0x007FFFFFu);
  const bool neg = (bits >> 31) != 0u;
  if (exp_f == 0xFF || (exp_f == 0 && man_f == 0)) return x;  // Inf NaN ±0
  if (exp_f == 0) return 0.0f;                 // fp32 subnormal -> +0.0
  const int bias = (1 << (eb - 1)) - 1;
  const int new_e = exp_f - 127 + bias;
  if (new_e >= (1 << eb) - 1)                  // saturate before rounding
    return __uint_as_float(neg ? 0xFF800000u : 0x7F800000u);
  const int shift = 23 - mb;
  const int man24 = man_f | (1 << 23);
  int man_out, e_out;
  if (new_e <= 0) {
    // subnormal target: truncating pre-shift (>= 24 wipes the
    // significand; the clamp keeps the C++ shift defined), then round
    man_out = round(man24 >> clampi(1 - new_e, 0, 24), shift);
    e_out = 1 - bias;
  } else {
    man_out = round(man24, shift);
    e_out = exp_f - 127;
  }
  // man * 2^(e - 23) as two exact power-of-two factors: a in [-126, 127]
  // carries the scale, b = e - a in [-23, 0] finishes a subnormal result
  // exactly; a rounding carry (man_out = 2^24) lands on 2^(e_out + 1)
  const int e = e_out - 23;
  const int a = clampi(e, -126, 127);
  const float mag = __fmul_rn(__fmul_rn(__int2float_rn(man_out), pow2i(a)),
                              pow2i(e - a));
  return neg ? -mag : mag;
}

// numerics.cast_body: RTNE cast of x into the (eb, mb) value set
__device__ __forceinline__ float cast(float x, int eb, int mb) {
  return cast_with(x, eb, mb, Rtne{});
}

// numerics.cast_body_sr: the SR cast with round bits r
__device__ __forceinline__ float cast_sr(float x, int eb, int mb,
                                         uint32_t r) {
  return cast_with(x, eb, mb, Sr{r});
}

// The per-format constants of cast_fadd and of K8's zero steps,
// computed once per launch on the host (ops/qgemm.py cast_constants) and
// passed by value; bias = 2^(eb-1) - 1 and shift = 23 - mb.
struct CastBits {
  uint32_t norm;     // (128 - bias) << 23: |x| at or above it has a
                     // normal target (new_e >= 1)
  uint32_t sat;      // (127 - bias + 2^eb - 1) << 23: |x| at or above it
                     // saturates (new_e >= 2^eb - 1)
  uint32_t tiny;     // max(128 - bias + shift - 24, 1) << 23: |x| below
                     // it casts to a zero (the round bit lies above the
                     // significand of a subnormal target)
  float kmul;        // 1.5 * 2^shift: cast_fadd's rounding constant
  int32_t exp_bits;
  int32_t man_bits;
  int32_t fadd;      // 1 where cast_fadd is exact: eb <= 7 and mb <= 21
};

// cast through the fp32 adder, for eb <= 7 and mb <= 21 (CastBits::fadd),
// where one formula covers zeros, normal and subnormal targets, so that
// lanes of a warp that hold different kinds of value take one path:
//   ct = ±max(|x|, 2^(1 - bias)): a subnormal target (|x| < 2^(1 - bias))
//        truncates to a multiple of T = 2^(-22 - bias), the format's
//        subnormal spacing over 2^shift, in (x +rz ct) - ct, since
//        |x| + 2^(1 - bias) lies in the binade whose ulp is T; a normal
//        target adds x to itself there, exactly, and subtracts it again;
//   m  = ±1.5 * 2^(max(e, 1 - bias) + shift), e the exponent of x:
//        (xt + m) - m rounds xt to a multiple of the target's quantum
//        q = 2^(max(e, 1 - bias) - mb) to nearest even, exactly, since
//        |xt| <= 2^22 q (mb <= 21) keeps the sum in the binade of m whose
//        ulp is q, and m / q is even;
//   the sign ORed back: a negative input that rounds to 0 gives -0, and
//        ±0 passes through.
// Saturation, Inf and NaN (|x| >= sat) set `flag` and return garbage; so
// does an fp32 subnormal input (it must give +0.0) where kSubnormalIn: a
// caller whose inputs are sums of outputs of this cast, multiples of the
// format's least subnormal 2^(1 - bias - mb) >= 2^-83, sees none.
template <bool kSubnormalIn>
__device__ __forceinline__ float cast_fadd(float x, const CastBits& f,
                                           bool& flag) {
  const uint32_t bits = __float_as_uint(x);
  const uint32_t u = bits & 0x7FFFFFFFu;
  flag |= u >= f.sat;
  if (kSubnormalIn) flag |= u - 1u < 0x007FFFFFu;
  const uint32_t ct = max(u, f.norm) | (bits & 0x80000000u);
  const float m = __fmul_rn(__uint_as_float(ct & 0xFF800000u), f.kmul);
  const float xt = __fsub_rn(__fadd_rz(x, __uint_as_float(ct)),
                             __uint_as_float(ct));
  const float r = __fsub_rn(__fadd_rn(xt, m), m);
  return __uint_as_float(__float_as_uint(r) | (bits & 0x80000000u));
}

// threefry2x32 with 20 rounds (quant/prng.py, bitwise jax.random's):
// (x0, x1) <- TF((k0, k1), (x0, x1)); uint32 arithmetic wraps as the
// plain version's masks do, and a rotate is one funnel shift
__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i % 2][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + uint32_t(i + 1);
  }
}

// prng.sr_bits_at: x0 ^ x1 of TF(TF(key, (0, offset)), (0, 0))
__device__ __forceinline__ uint32_t sr_bits_at(uint32_t k0, uint32_t k1,
                                               uint32_t offset) {
  uint32_t a = 0u, b = offset;
  threefry2x32(k0, k1, a, b);
  uint32_t x0 = 0u, x1 = 0u;
  threefry2x32(a, b, x0, x1);
  return x0 ^ x1;
}

// numerics.pack_code: a value of the (eb, mb) set -> its code word
// [ man (mb) | exp (eb) | sign ]; the all-ones exponent field holds the
// specials: man 0 -> ±Inf, man 1 -> ±2^(emax+1) (the carry), man 2 -> NaN
__device__ __forceinline__ uint32_t pack_code(float x, int eb, int mb) {
  const uint32_t bits = __float_as_uint(x);
  if (eb == 8 && mb == 23) return bits;
  const uint32_t sign = bits >> 31;
  const int exp_f = int((bits >> 23) & 0xFFu);
  const int man_f = int(bits & 0x007FFFFFu);
  const int bias = (1 << (eb - 1)) - 1;
  const int ones = (1 << eb) - 1;
  const uint32_t top = uint32_t(ones) << mb;
  const uint32_t top_sign = sign << (eb + mb);   // eb + mb <= 30 here
  if (exp_f == 0xFF) return man_f != 0 ? (top | 2u) : (top_sign | top);
  // fp32 subnormals have no implicit bit and a fixed 2^-126 scale
  const int man24 = exp_f > 0 ? (man_f | (1 << 23)) : man_f;
  const int f = (exp_f > 0 ? exp_f - 127 : -126) + bias;
  const bool is_sub = f <= 0 || exp_f == 0;
  if (!is_sub && f >= ones) return top_sign | top | 1u;   // the carry value
  uint32_t exp_field, man_field;
  if (is_sub) {
    const int shift = clampi(max(1 - f, 0) + (23 - mb), 0, 31);
    exp_field = 0u;
    man_field = uint32_t(man24 >> shift);
  } else {
    exp_field = uint32_t(clampi(f, 0, ones));
    man_field = uint32_t(man_f >> (23 - mb));
  }
  return top_sign | (exp_field << mb) | man_field;
}

// numerics.unpack_code: code word -> the exact fp32 the cast produced
__device__ __forceinline__ float unpack_code(uint32_t code, int eb, int mb) {
  if (eb == 8 && mb == 23) return __uint_as_float(code);
  const int bias = (1 << (eb - 1)) - 1;
  const int ones = (1 << eb) - 1;
  const bool neg = ((code >> (eb + mb)) & 1u) != 0;
  const int ef = int((code >> mb) & uint32_t(ones));
  const int mf = int(code & ((1u << mb) - 1u));
  const bool special = ef == ones;
  if (special && mf >= 2) return __uint_as_float(0x7FC00000u);   // NaN
  if (special && mf == 0)
    return __uint_as_float(neg ? 0xFF800000u : 0x7F800000u);     // ±Inf
  const bool sub = ef == 0;
  int mant = sub ? mf : (mf | (1 << mb));
  int e = (sub ? 1 : ef) - bias - mb;
  if (special) {              // the carry value 1 * 2^(e_max + 1)
    mant = 1;
    e = ones - bias;
  }
  const int a = clampi(e, -126, 127);
  const int b = clampi(e - a, -126, 127);
  const float mag = __fmul_rn(__fmul_rn(__int2float_rn(mant), pow2i(a)),
                              pow2i(b));
  return neg ? -mag : mag;
}

// numerics.format_max_exponent: the exponent of the format's max finite
__device__ __forceinline__ int format_max_exponent(int eb) {
  return ((1 << eb) - 2) - ((1 << (eb - 1)) - 1);
}

// numerics.max_finite: (2 - 2^-mb) * 2^emax, from its bits
__device__ __forceinline__ float max_finite(int eb, int mb) {
  const uint32_t man = mb == 0 ? 0u : (0x7FFFFFu & ~((1u << (23 - mb)) - 1u));
  return __uint_as_float((uint32_t(format_max_exponent(eb) + 127) << 23) |
                         man);
}

__device__ __forceinline__ int exp_field(float x) {
  return int((__float_as_uint(x) >> 23) & 0xFFu);
}

__device__ __forceinline__ bool is_finite(float x) {
  return exp_field(x) != 0xFF;
}

// numerics._flush_low: every pattern with a zero exponent field (±0, fp32
// subnormals) -> +0.0
__device__ __forceinline__ float flush_low(float x) {
  return exp_field(x) == 0 ? 0.0f : x;
}

// the exponent e of torch.frexp (x = f * 2^e, f in [0.5, 1)) of a finite
// nonzero x, subnormals included
__device__ __forceinline__ int frexp_exp(float x) {
  const uint32_t b = __float_as_uint(x) & 0x7FFFFFFFu;
  const int ef = int(b >> 23);
  return ef != 0 ? ef - 126 : (32 - __clz(b)) - 149;
}

// numerics._scale_pow2: x * 2^e for e in [-252, 253] as two exact factors
__device__ __forceinline__ float scale_pow2(float x, int e) {
  const int a = clampi(e, -126, 127);
  return __fmul_rn(__fmul_rn(x, pow2i(a)), pow2i(clampi(e - a, -126, 126)));
}

constexpr uint32_t kDigestMod = 65521;

// x mod 65521 with shifts and adds (2^16 = 15 mod 65521), exact for every
// uint32 -- ops/quantize.py fletcher_mod65521 of the JAX package
__device__ __forceinline__ uint32_t fletcher_mod65521(uint32_t x) {
  x = (x & 0xFFFFu) + (x >> 16) * 15u;   // < 2^20
  x = (x & 0xFFFFu) + (x >> 16) * 15u;   // < 65761
  return x >= kDigestMod ? x - kDigestMod : x;
}

}  // namespace exmy
