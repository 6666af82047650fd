// The quantized-Kahan-accumulator GEMM: (M, K) @ (K, N) -> (M, N) fp32
// with every intermediate of the Kahan-compensated dot product re-cast
// to eXmY (RTNE), K walked strictly in ascending order.
//
// Replaces K8, cpd_tpu/ops/qgemm.py:64 qgemm_pallas (body _qgemm_kernel
// :41), itself bit-identical to cpd_tpu/quant/quant_function.py's
// faithful lax.scan (:254-289).  Per output element, for k = 0..K-1:
//   tmp = q(a[m,k] * b[k,n]);  y = q(tmp - c);  t = q(s + y);
//   c = q(q(t - s) - y);  s = t
// with s = c = 0 to start and q the RTNE cast (bitwise the plain
// version's cast_body).  Every float op is __fmul_rn/__fadd_rn/__fsub_rn:
// no FMA contraction, no flush of subnormal products, so the card
// computes the bits the plain torch scan computes.  K is never padded: a
// step on a zero product is not a Kahan no-op once c != 0.
//
// What bounds it.  Five casts and five float ops per (m, n, k) step, on
// the CUDA cores: tensor cores cannot serve, since every product is
// requantized before it is summed (the trade the reference's tvm_gemm and
// the TPU kernel, on the VPU and not the MXU, made too).  The bytes
// (each operand read once) are negligible; the instructions one Kahan
// step issues are the bound (chip_smoke.py phase 10a counts them in this
// build's SASS).  The generic cast (exmy::cast: fields taken apart, three
// arms, an integer RTNE, the value rebuilt by a conversion and two
// power-of-two products) is ~24 ALU instructions, ~118 per step.  With
// cast_fadd below the work itself is 30 ALU and 30 fp32 instructions per
// step (five casts of 6 + 5, and the step's five float ops): 60 issued,
// as bound by the ALU pipe as by issue.  This kernel's loop issues 69
// per step that casts, 34 of them on the ALU pipe and 30 on the fp32
// pipe (e4m3, this build's SASS): shared-memory loads, loop control, the
// flag ORs and the vote on them, and register moves on top of the work.
//
// What this kernel does about it.
// * The cast through the fp32 adder with per-format constants from the
//   host (exmy::CastBits), no per-element recomputation.  For eb <= 7 and
//   mb <= 21 (e4m3, e5m2, ...) exmy::cast_fadd: the fp32 adder aligns and
//   rounds ((x +rz ct) - ct truncates a subnormal target, (xt + m) - m
//   rounds it to nearest even), 6 ALU instructions and 5 fp32 ones, and
//   one formula for zeros, normal and subnormal targets.  That matters
//   because on forward operands no kind is warp-uniform: chip_smoke.py's
//   census (phase 10a, e4m3) finds zeros, normal and subnormal targets
//   each a sizeable share of every step's casts, so a cast that branched
//   by kind would run every arm in nearly every warp.  Other formats
//   (eb = 8, mb >= 22), on no timed path, keep the reference cast
//   exmy::cast in the same tile.
// * Branching by data only where it is warp-uniform: the zero step.  On
//   the backward's gradients most products round to a signed zero while
//   s and c are still ±0; then every later cast of the step passes ±0
//   through, and the step is its five float ops.  Per 32-step K chunk a
//   warp finds its zero steps from a bound, max|a| * max|b| < tiny over
//   its rows and the tile's columns (rounding is monotonic), and takes
//   them while its s and c stay ±0.  Tried on the card on the LM's
//   operands of one rank-step and dropped: a vote per cast group (the
//   votes cut the step into blocks the scheduler cannot interleave: the
//   forward lost more than the backward gained), a check of the products
//   and of s and c at every step (slower on both), and no zero steps
//   (the backward as slow as the forward).  Saturation, Inf, NaN and
//   fp32-subnormal products, which cast_fadd does not cover, set a flag;
//   where a warp saw one, the step's results are dropped and the warp
//   finishes its K chunk with the reference cast (exmy::cast).
// * A register tile: each thread owns 2 x 2 outputs (rows ty, ty + 16;
//   columns tx, tx + 16 of a 32 x 32 CTA tile), four independent Kahan
//   chains that the scheduler interleaves, and the shared-memory loads and
//   loop overhead spread over four steps.  K goes through shared memory in
//   chunks of 32: A's chunk transposed with a padded row (As[k][m], 33
//   words, so its transposing stores do not conflict), B's as it lies.
//   M and N tails are masked (their lanes run on zeros and store nothing);
//   the last K chunk runs only its k < K steps.
//
// The CTA-per-16x16-tile kernel with one output per thread and exmy::cast
// that this one replaced is kept as qgemm_generic_launch: no path calls
// it; chip_smoke.py times this kernel against it in turns and uses it as
// a fast second oracle.
//
// Two more arms of the same tile kernel (qgemm_arm_launch), as cast
// policies:
// * SR (SrCast): the five casts of a step stochastically rounded, as the
//   JAX package's SR faithful scan draws them
//   (cpd_tpu/quant/quant_function.py:257-285): the bits of output (m, n)
//   at (k, site) are x0 ^ x1 of threefry2x32(site_key[k][site], (0,
//   m * N + n)), N unpadded, i.e. random_bits(site_key, (M, N)), with
//   site_key[k][site] = fold_in(fold_in(key, k), site) from a (K, 5)
//   table that one small kernel (site_keys_kernel) computes before the
//   product, once per call, and the CTA stages a K chunk at a time.  The cast is K2's (exmy::cast_sr); no zero steps,
//   since a tiny product may round up.  Bound: five threefry2x32
//   evaluations a step (~45 ALU instructions each, the flat sr_bits
//   arm's count) and five casts, on the ALU pipe.
// * Stats (Counted<Q>, on the RTNE and the SR arm): each thread counts
//   sat / underflow / nan of every cast it commits (numerics.quant_health
//   by bit pattern; a zero step's product that is not ±0 is an
//   underflow), a warp folds them, and lane 0 adds them with int64
//   atomics into a (4,) counter with the total 5 * K * live outputs.
//   The product is bitwise the arm without counting.

#include <cuda_runtime.h>
#include <stdint.h>

#include "exmy.cuh"

namespace {

constexpr int kSide = 16;             // threads per CTA side
constexpr int kThreads = kSide * kSide;
constexpr int kTile = 2 * kSide;      // outputs per CTA side
constexpr int kChunk = 32;            // K steps staged in shared memory
constexpr uint32_t kFullWarp = 0xFFFFFFFFu;
constexpr int kSites = 5;             // cast sites of a Kahan step

// one thread's counts of the stats arm: numerics.quant_health's sat /
// underflow / nan of a cast (input x, output q), read off the bit patterns
struct Tally {
  uint32_t sat = 0u, under = 0u, nan = 0u;
  __device__ __forceinline__ void add(float x, float q) {
    const uint32_t xm = __float_as_uint(x) & 0x7FFFFFFFu;
    const uint32_t qm = __float_as_uint(q) & 0x7FFFFFFFu;
    sat += qm == 0x7F800000u;
    under += qm == 0u && xm != 0u && xm < 0x7F800000u;
    nan += xm > 0x7F800000u;
  }
  __device__ __forceinline__ void operator+=(const Tally& o) {
    sat += o.sat;
    under += o.under;
    nan += o.nan;
  }
};

// the reference cast, counted into `tally` where kStats
template <bool kStats>
__device__ __forceinline__ float ref_cast(float x, int eb, int mb,
                                          Tally& tally) {
  const float q = exmy::cast(x, eb, mb);
  if constexpr (kStats) tally.add(x, q);
  return q;
}

// one step of the quantized Kahan recurrence (quant_function.py:276-279)
// with the reference cast
template <bool kStats = false>
__device__ __forceinline__ void kahan_step(float& s, float& c, float a,
                                           float b, int eb, int mb,
                                           Tally& tally) {
  const float tmp = ref_cast<kStats>(__fmul_rn(a, b), eb, mb, tally);
  const float y = ref_cast<kStats>(__fsub_rn(tmp, c), eb, mb, tally);
  const float t = ref_cast<kStats>(__fadd_rn(s, y), eb, mb, tally);
  c = ref_cast<kStats>(
      __fsub_rn(ref_cast<kStats>(__fsub_rn(t, s), eb, mb, tally), y), eb,
      mb, tally);
  s = t;
}

// the tile kernel's cast for eb <= 7 and mb <= 21; kProduct: the input is
// a product a * b, which may be an fp32 subnormal
struct FaddCast {
  static constexpr bool kFlags = true;
  static constexpr bool kSR = false;
  static constexpr bool kStats = false;
  exmy::CastBits f;
  template <bool kProduct>
  __device__ __forceinline__ float cast(float x, bool& flag) const {
    return exmy::cast_fadd<kProduct>(x, f, flag);
  }
};

// the tile kernel's cast for every other format: the reference cast
struct RefCast {
  static constexpr bool kFlags = false;
  static constexpr bool kSR = false;
  static constexpr bool kStats = false;
  exmy::CastBits f;
  template <bool kProduct>
  __device__ __forceinline__ float cast(float x, bool&) const {
    return exmy::cast(x, f.exp_bits, f.man_bits);
  }
};

// the SR arm: K2's cast (exmy::cast_sr) with bits drawn in the kernel
// from the (k, kSites) table of site keys
struct SrCast {
  static constexpr bool kFlags = false;
  static constexpr bool kSR = true;
  static constexpr bool kStats = false;
  exmy::CastBits f;
  const uint2* keys;
};

// a cast policy with the stats arm's counts, folded into counts[0..3]
template <class Q>
struct Counted : Q {
  static constexpr bool kStats = true;
  unsigned long long* counts;
};

// the cast of a thread's four values at one point of the step
template <bool kProduct, class Q>
__device__ __forceinline__ void cast4(float (&v)[4], const Q& q,
                                      bool& flag, Tally& tally) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x = v[i];
    v[i] = q.template cast<kProduct>(x, flag);
    if constexpr (Q::kStats) tally.add(x, v[i]);
  }
}

// a zero step of the thread's 2 x 2 outputs (output i: A row i / 2, B
// column i % 2): every product casts to a zero and every s and c is ±0,
// so every later cast of the step sees ±0 and passes it through, and the
// step is its float ops alone
__device__ __forceinline__ void zero_step(float (&s)[4], float (&c)[4],
                                          const float (&ar)[2],
                                          const float (&br)[2]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // the product's cast: ±0 passes, an fp32 subnormal flushes to +0.0, a
    // normal value rounds to a signed zero
    const uint32_t bits = __float_as_uint(__fmul_rn(ar[i >> 1], br[i & 1]));
    const float z = __uint_as_float(
        (bits & 0x7FFFFFFFu) - 1u < 0x007FFFFFu ? 0u : bits & 0x80000000u);
    const float y = __fsub_rn(z, c[i]);
    const float t = __fadd_rn(s[i], y);
    c[i] = __fsub_rn(__fsub_rn(t, s[i]), y);
    s[i] = t;
  }
}

// the stats arm's counts of a zero step: the product's cast underflows
// where the product is not ±0; every later cast of the step sees ±0
__device__ __forceinline__ void zero_step_tally(const float (&ar)[2],
                                                const float (&br)[2],
                                                Tally& tally) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    tally.under += (__float_as_uint(__fmul_rn(ar[i >> 1], br[i & 1])) &
                    0x7FFFFFFFu) != 0u;
}

// one Kahan step of the thread's 2 x 2 outputs.  Returns false, leaving s
// and c as they were, where a cast input of the step in the warp was not
// covered by Q's cast.
template <class Q>
__device__ __forceinline__ bool tile_step(float (&s)[4], float (&c)[4],
                                          const float (&ar)[2],
                                          const float (&br)[2],
                                          const Q& q, Tally& tally) {
  bool flag = false;
  Tally step;        // the step's counts, kept where the step stands
  float tmp[4], y[4], t[4], d[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) tmp[i] = __fmul_rn(ar[i >> 1], br[i & 1]);
  cast4<true>(tmp, q, flag, step);
#pragma unroll
  for (int i = 0; i < 4; ++i) y[i] = __fsub_rn(tmp[i], c[i]);
  cast4<false>(y, q, flag, step);
#pragma unroll
  for (int i = 0; i < 4; ++i) t[i] = __fadd_rn(s[i], y[i]);
  cast4<false>(t, q, flag, step);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = __fsub_rn(t[i], s[i]);
  cast4<false>(d, q, flag, step);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = __fsub_rn(d[i], y[i]);
  cast4<false>(d, q, flag, step);
  if (Q::kFlags && __any_sync(kFullWarp, flag)) return false;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    c[i] = d[i];
    s[i] = t[i];
  }
  if constexpr (Q::kStats) tally += step;
  return true;
}

// the SR arm's bits of the output at flat index idx for one (k, site)
// key: x0 ^ x1 of threefry2x32(key, (0, idx)) (prng.random_bits)
__device__ __forceinline__ uint32_t site_bits(uint2 key, uint32_t idx) {
  uint32_t x0 = 0u, x1 = idx;
  exmy::threefry2x32(key.x, key.y, x0, x1);
  return x0 ^ x1;
}

// one SR Kahan step of the thread's 2 x 2 outputs (flat indices idx),
// the step's kSites keys at `keys`
template <class Q>
__device__ __forceinline__ void sr_step(float (&s)[4], float (&c)[4],
                                        const float (&ar)[2],
                                        const float (&br)[2],
                                        const uint2* keys,
                                        const uint32_t (&idx)[4],
                                        const Q& q, Tally& tally) {
  const int eb = q.f.exp_bits, mb = q.f.man_bits;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    auto cast = [&](float x, int site) {
      const float r = exmy::cast_sr(x, eb, mb, site_bits(keys[site], idx[i]));
      if constexpr (Q::kStats) tally.add(x, r);
      return r;
    };
    const float tmp = cast(__fmul_rn(ar[i >> 1], br[i & 1]), 0);
    const float y = cast(__fsub_rn(tmp, c[i]), 1);
    const float t = cast(__fadd_rn(s[i], y), 2);
    c[i] = cast(__fsub_rn(cast(__fsub_rn(t, s[i]), 3), y), 4);
    s[i] = t;
  }
}

// one K chunk of the round-to-nearest arms (staged in as / bs): zero
// steps while they hold, tile steps through Q's cast, and the reference
// cast for the rest of the chunk after a step Q does not cover
template <class Q>
__device__ __forceinline__ void rtne_chunk(
    float (&s)[4], float (&c)[4], const float (&as)[kChunk][kTile + 1],
    const float (&bs)[kChunk][kTile], uint32_t (&bmax)[kChunk], int kc,
    int tx, int ty, int warp, int lane, const Q& q, Tally& tally) {
  // the chunk's zero steps for this warp (rows 2w, 2w + 1, 2w + 16,
  // 2w + 17, the tile's 32 columns): |a * b| <= max|a| * max|b|, since
  // rounding is monotonic, so where that bound is below tiny every
  // product of step k casts to a zero (NaN and Inf bounds compare
  // false); |x| is ordered as its bit pattern
#pragma unroll
  for (int kb = 4 * warp; kb < 4 * warp + 4; ++kb) {
    const uint32_t top = __reduce_max_sync(
        kFullWarp, __float_as_uint(bs[kb][lane]) & 0x7FFFFFFFu);
    if (lane == 0) bmax[kb] = top;
  }
  __syncthreads();
  uint32_t amax = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    amax = max(amax, __float_as_uint(as[lane][2 * warp + (i & 1) +
                                              (i >> 1) * kSide]) &
                         0x7FFFFFFFu);
  const uint32_t zero_steps = __ballot_sync(
      kFullWarp, lane < kc && __fmul_rn(__uint_as_float(amax),
                                        __uint_as_float(bmax[lane])) <
                                  __uint_as_float(q.f.tiny));
  // and every s and c of the warp is ±0 (until a step that casts)
  uint32_t state = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    state |= __float_as_uint(s[i]) | __float_as_uint(c[i]);
  bool zeros = __all_sync(kFullWarp, (state & 0x7FFFFFFFu) == 0u);
  int kk = 0;
#pragma unroll 1
  for (; kk < kc; ++kk) {
    const float ar[2] = {as[kk][ty], as[kk][ty + kSide]};
    const float br[2] = {bs[kk][tx], bs[kk][tx + kSide]};
    if (zeros && ((zero_steps >> kk) & 1u)) {
      if constexpr (Q::kStats) zero_step_tally(ar, br, tally);
      zero_step(s, c, ar, br);
      continue;
    }
    zeros = false;
    if (!tile_step(s, c, ar, br, q, tally)) break;
  }
  // a value the tile's cast does not cover: the rest of the chunk
  // through the reference cast
#pragma unroll 1
  for (; kk < kc; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      kahan_step<Q::kStats>(s[i], c[i], as[kk][ty + (i >> 1) * kSide],
                            bs[kk][tx + (i & 1) * kSide], q.f.exp_bits,
                            q.f.man_bits, tally);
  }
}

template <class Q>
__global__ void __launch_bounds__(kThreads)
    qgemm_tile_kernel(const float* __restrict__ a,
                      const float* __restrict__ b, float* __restrict__ out,
                      int m, int n, int k, Q q) {
  __shared__ float as[kChunk][kTile + 1];
  __shared__ float bs[kChunk][kTile];
  __shared__ uint32_t bmax[kChunk];
  const int tx = threadIdx.x % kSide;
  const int ty = threadIdx.x / kSide;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  Tally tally;
  // the SR arm's flat output indices m * N + n (mod 2^32; M * N < 2^32)
  uint32_t idx[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    idx[i] = static_cast<uint32_t>(row0 + ty + (i >> 1) * kSide) *
                 static_cast<uint32_t>(n) +
             static_cast<uint32_t>(col0 + tx + (i & 1) * kSide);
  for (int k0 = 0; k0 < k; k0 += kChunk) {
    const int kc = min(kChunk, k - k0);
    // stage A[row0 : row0+32, k0 : k0+32] transposed and
    // B[k0 : k0+32, col0 : col0+32]; 1024 words each, four per thread
    for (int i = threadIdx.x; i < kChunk * kTile; i += kThreads) {
      const int r = i / kChunk, kk = i % kChunk;       // A: along k
      const int gr = row0 + r;
      as[kk][r] = (gr < m && kk < kc)
                      ? a[static_cast<long long>(gr) * k + k0 + kk]
                      : 0.0f;
      const int kb = i / kTile, cc = i % kTile;        // B: along n
      const int gc = col0 + cc;
      bs[kb][cc] = (gc < n && kb < kc)
                       ? b[static_cast<long long>(k0 + kb) * n + gc]
                       : 0.0f;
    }
    if constexpr (Q::kSR) {
      // the chunk's (k, site) keys, then its steps, each cast SR
      extern __shared__ uint2 chunk_keys[];
      for (int i = threadIdx.x; i < kc * kSites; i += kThreads)
        chunk_keys[i] = q.keys[static_cast<long long>(k0) * kSites + i];
      __syncthreads();
#pragma unroll 1
      for (int kk = 0; kk < kc; ++kk) {
        const float ar[2] = {as[kk][ty], as[kk][ty + kSide]};
        const float br[2] = {bs[kk][tx], bs[kk][tx + kSide]};
        sr_step(s, c, ar, br, &chunk_keys[kk * kSites], idx, q, tally);
      }
    } else {
      __syncthreads();
      rtne_chunk(s, c, as, bs, bmax, kc, tx, ty, warp, lane, q, tally);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty + (i >> 1) * kSide;
    const int gc = col0 + tx + (i & 1) * kSide;
    if (gr < m && gc < n) out[static_cast<long long>(gr) * n + gc] = s[i];
  }
  if constexpr (Q::kStats) {
    // the warp's counts, then one int64 atomic a counter from lane 0;
    // the total is five casts a step for each output of the thread
    int live = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      live += row0 + ty + (i >> 1) * kSide < m &&
              col0 + tx + (i & 1) * kSide < n;
    unsigned long long v[4] = {tally.sat, tally.under, tally.nan,
                               static_cast<unsigned long long>(kSites) *
                                   static_cast<unsigned long long>(k) *
                                   live};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v[j] += __shfl_down_sync(kFullWarp, v[j], off);
      if (lane == 0 && v[j] != 0ull) atomicAdd(q.counts + j, v[j]);
    }
  }
}

// the SR arm's key table: keys[j][site] = fold_in(fold_in(key, j), site)
// for step j < k (prng.fold_in(key, d) = threefry2x32(key, (0, d)))
__global__ void site_keys_kernel(uint32_t k0, uint32_t k1, int k,
                                 uint2* __restrict__ keys) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= k) return;
  uint32_t a0 = 0u, a1 = static_cast<uint32_t>(j);
  exmy::threefry2x32(k0, k1, a0, a1);
#pragma unroll
  for (int site = 0; site < kSites; ++site) {
    uint32_t b0 = 0u, b1 = static_cast<uint32_t>(site);
    exmy::threefry2x32(a0, a1, b0, b1);
    keys[static_cast<long long>(j) * kSites + site] = make_uint2(b0, b1);
  }
}

// The kernel the tile kernel replaced, kept as its yardstick: a CTA owns
// a 16 x 16 output tile, one output per thread, K staged in chunks of 32,
// exmy::cast throughout.
__global__ void __launch_bounds__(kThreads)
    qgemm_generic_kernel(const float* __restrict__ a,
                         const float* __restrict__ b,
                         float* __restrict__ out, int m, int n, int k,
                         int eb, int mb) {
  __shared__ float as[kChunk][kSide];
  __shared__ float bs[kChunk][kSide];
  const int tx = threadIdx.x % kSide;
  const int ty = threadIdx.x / kSide;
  const int row0 = blockIdx.y * kSide;
  const int col0 = blockIdx.x * kSide;
  float s = 0.0f, c = 0.0f;
  Tally unused;
  for (int k0 = 0; k0 < k; k0 += kChunk) {
    const int kc = min(kChunk, k - k0);
    for (int i = threadIdx.x; i < kChunk * kSide; i += kThreads) {
      const int r = i / kChunk, kk = i % kChunk;
      const int gr = row0 + r;
      as[kk][r] = (gr < m && kk < kc)
                      ? a[static_cast<long long>(gr) * k + k0 + kk]
                      : 0.0f;
      const int kb = i / kSide, cc = i % kSide;
      const int gc = col0 + cc;
      bs[kb][cc] = (gc < n && kb < kc)
                       ? b[static_cast<long long>(k0 + kb) * n + gc]
                       : 0.0f;
    }
    __syncthreads();
#pragma unroll 1
    for (int kk = 0; kk < kc; ++kk)
      kahan_step(s, c, as[kk][ty], bs[kk][tx], eb, mb, unused);
    __syncthreads();
  }
  const int gr = row0 + ty, gc = col0 + tx;
  if (gr < m && gc < n) out[static_cast<long long>(gr) * n + gc] = s;
}

}  // namespace

// out (m, n) = the quantized-Kahan product of a (m, k) and b (k, n), all
// fp32, contiguous row-major, in the format whose constants ``f`` holds
// (ops/qgemm.py cast_constants).  Returns the cudaError of the launch.
extern "C" int qgemm_launch(const void* a, const void* b, void* out, int m,
                            int n, int k, exmy::CastBits f, void* stream) {
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* pa = static_cast<const float*>(a);
  const auto* pb = static_cast<const float*>(b);
  auto* po = static_cast<float*>(out);
  if (f.fadd)
    qgemm_tile_kernel<FaddCast><<<grid, kThreads, 0, st>>>(pa, pb, po, m, n,
                                                           k, FaddCast{f});
  else
    qgemm_tile_kernel<RefCast><<<grid, kThreads, 0, st>>>(pa, pb, po, m, n,
                                                          k, RefCast{f});
  return int(cudaGetLastError());
}

template <class Q>
int launch_tile(const void* a, const void* b, void* out, int m, int n,
                int k, Q q, size_t smem, void* stream) {
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  qgemm_tile_kernel<Q><<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(out), m, n, k, q);
  return int(cudaGetLastError());
}

// The SR and stats arms of the same product: ``keys`` (scratch for k x
// 5 pairs of uint32, filled here from the key (key0, key1)) selects the
// SR cast, null the round-to-nearest one; ``counts`` (4 int64, zeroed by
// the caller: sat, underflow, nan, total) the stats arm, null none.
// Returns the cudaError of the launches.
extern "C" int qgemm_arm_launch(const void* a, const void* b, void* out,
                                int m, int n, int k, exmy::CastBits f,
                                uint32_t key0, uint32_t key1, void* keys,
                                void* counts, void* stream) {
  auto* cnt = static_cast<unsigned long long*>(counts);
  if (keys != nullptr) {
    auto* table = static_cast<uint2*>(keys);
    site_keys_kernel<<<(k + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(key0, key1, k,
                                                            table);
    const int rc = int(cudaGetLastError());
    if (rc != 0) return rc;
    const SrCast sr{f, table};
    const size_t smem = kChunk * kSites * sizeof(uint2);
    if (cnt != nullptr)
      return launch_tile(a, b, out, m, n, k, Counted<SrCast>{sr, cnt}, smem,
                         stream);
    return launch_tile(a, b, out, m, n, k, sr, smem, stream);
  }
  if (cnt == nullptr) return qgemm_launch(a, b, out, m, n, k, f, stream);
  if (f.fadd)
    return launch_tile(a, b, out, m, n, k, Counted<FaddCast>{FaddCast{f}, cnt},
                       0, stream);
  return launch_tile(a, b, out, m, n, k, Counted<RefCast>{RefCast{f}, cnt}, 0,
                     stream);
}

// the same product through the kept generic kernel (the yardstick)
extern "C" int qgemm_generic_launch(const void* a, const void* b, void* out,
                                    int m, int n, int k, int exp_bits,
                                    int man_bits, void* stream) {
  const dim3 grid((n + kSide - 1) / kSide, (m + kSide - 1) / kSide);
  qgemm_generic_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(out), m, n, k, exp_bits, man_bits);
  return int(cudaGetLastError());
}

extern "C" const char* qgemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
