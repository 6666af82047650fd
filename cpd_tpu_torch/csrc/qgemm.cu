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

#include <cuda_runtime.h>
#include <stdint.h>

#include "exmy.cuh"

namespace {

constexpr int kSide = 16;             // threads per CTA side
constexpr int kThreads = kSide * kSide;
constexpr int kTile = 2 * kSide;      // outputs per CTA side
constexpr int kChunk = 32;            // K steps staged in shared memory
constexpr uint32_t kFullWarp = 0xFFFFFFFFu;

// one step of the quantized Kahan recurrence (quant_function.py:276-279)
// with the reference cast
__device__ __forceinline__ void kahan_step(float& s, float& c, float a,
                                           float b, int eb, int mb) {
  const float tmp = exmy::cast(__fmul_rn(a, b), eb, mb);
  const float y = exmy::cast(__fsub_rn(tmp, c), eb, mb);
  const float t = exmy::cast(__fadd_rn(s, y), eb, mb);
  c = exmy::cast(__fsub_rn(exmy::cast(__fsub_rn(t, s), eb, mb), y), eb,
                 mb);
  s = t;
}

// the tile kernel's cast for eb <= 7 and mb <= 21; kProduct: the input is
// a product a * b, which may be an fp32 subnormal
struct FaddCast {
  static constexpr bool kFlags = true;
  exmy::CastBits f;
  template <bool kProduct>
  __device__ __forceinline__ float cast(float x, bool& flag) const {
    return exmy::cast_fadd<kProduct>(x, f, flag);
  }
};

// the tile kernel's cast for every other format: the reference cast
struct RefCast {
  static constexpr bool kFlags = false;
  exmy::CastBits f;
  template <bool kProduct>
  __device__ __forceinline__ float cast(float x, bool&) const {
    return exmy::cast(x, f.exp_bits, f.man_bits);
  }
};

// the cast of a thread's four values at one point of the step
template <bool kProduct, class Q>
__device__ __forceinline__ void cast4(float (&v)[4], const Q& q,
                                      bool& flag) {
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = q.template cast<kProduct>(v[i], flag);
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

// one Kahan step of the thread's 2 x 2 outputs.  Returns false, leaving s
// and c as they were, where a cast input of the step in the warp was not
// covered by Q's cast.
template <class Q>
__device__ __forceinline__ bool tile_step(float (&s)[4], float (&c)[4],
                                          const float (&ar)[2],
                                          const float (&br)[2],
                                          const Q& q) {
  bool flag = false;
  float tmp[4], y[4], t[4], d[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) tmp[i] = __fmul_rn(ar[i >> 1], br[i & 1]);
  cast4<true>(tmp, q, flag);
#pragma unroll
  for (int i = 0; i < 4; ++i) y[i] = __fsub_rn(tmp[i], c[i]);
  cast4<false>(y, q, flag);
#pragma unroll
  for (int i = 0; i < 4; ++i) t[i] = __fadd_rn(s[i], y[i]);
  cast4<false>(t, q, flag);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = __fsub_rn(t[i], s[i]);
  cast4<false>(d, q, flag);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = __fsub_rn(d[i], y[i]);
  cast4<false>(d, q, flag);
  if (Q::kFlags && __any_sync(kFullWarp, flag)) return false;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    c[i] = d[i];
    s[i] = t[i];
  }
  return true;
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
    __syncthreads();
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
        zero_step(s, c, ar, br);
        continue;
      }
      zeros = false;
      if (!tile_step(s, c, ar, br, q)) break;
    }
    // a value the tile's cast does not cover: the rest of the chunk
    // through the reference cast
#pragma unroll 1
    for (; kk < kc; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        kahan_step(s[i], c[i], as[kk][ty + (i >> 1) * kSide],
                   bs[kk][tx + (i & 1) * kSide], q.f.exp_bits,
                   q.f.man_bits);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty + (i >> 1) * kSide;
    const int gc = col0 + tx + (i & 1) * kSide;
    if (gr < m && gc < n) out[static_cast<long long>(gr) * n + gc] = s[i];
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
    for (int kk = 0; kk < kc; ++kk) kahan_step(s, c, as[kk][ty], bs[kk][tx],
                                               eb, mb);
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
