// The eXmY quantize kernels of the ring reduce: the elementwise cast, the
// fused add-and-cast, the fused hop that unpacks, adds, casts, re-packs
// and digests the packed wire, each with round-to-nearest-even or
// stochastic rounding, and the SR bit generator they are fed from.
//
// Replaces six TPU kernels of cpd_tpu/ops/quantize.py:
//   K1 quantize_pallas (:69, body _quantize_kernel :42)   cast(x)
//   K2 quantize_pallas_sr (:170, body :46)                cast_sr(x, r)
//   K3 quantize_add_pallas (:107, body :95)               cast(x + y)
//   K4 quantize_add_pallas_bits (:137, body :100)         cast_sr(x + y, r)
//   K6 quantize_pack_pallas (:634)    hop 0: cast[_sr](g), pack (+ digest)
//   K5 hop_pack_pallas (:512)         hop t: cast[_sr](unpack(wire) + g),
//                                     pack (+ digests of both wires)
//   K6/K5 blocked arm (block_size; _make_wire_kernel :314-362)
//                                     the same hops over the block-scaled
//                                     wire: per-block power-of-2 shift,
//                                     cast, clamp, sidecar (+ digests)
//   K7 digest_rows_pallas (:582, body :541)
//                                     per-row Fletcher digest of (W, B) u8
// K5 and K6 share their body (_make_wire_kernel :271 / _wire_call :409),
// and so do their ports here: one kernel templated on kFirst and kSR (as
// K1-K4 share one templated on kAdd and kSR), run_wire_kernel; their
// blocked arm is a second kernel, run_blocked_kernel, templated the same
// way.  The kernels they replaced, wire_kernel and blocked_wire_kernel
// with their fold_kernel launch, stay below as the yardstick.  The
// per-element arithmetic is exmy.cuh, bitwise the plain version's.  Like
// the TPU kernels, the SR arms take their uint32 round bits as an
// operand.  Those bits come from
// sr_bits_kernel, the port of what the JAX package computes in XLA
// (numerics.sr_bits_at: two threefry2x32 per element); it is bound by
// the integer instructions it issues per element (about two on the
// 64-lane ALU pipe per threefry round), not by its 4 written bytes.
// flat_bits_kernel is its one-threefry arm: jax.random.bits(key, shape)
// by flat index (numerics.cast_to_format_sr), the bits of quant_sgd's
// casts and of the emulate-node pre-quantize.
//
// What bounds them.  Each is a streaming pass of a few integer ops per
// element: 8 bytes per element for the cast (read 4, write 4), 12 for the
// add, 8 + wb for hop 0 and 2 (4 + wb) for a later hop, at 3.35 TB/s;
// the SR arms read 4 more bytes of round bits.
// At the ring chunk of ResNet-18/CIFAR (988,944 elements at W = 4) a
// (5, 2) hop moves ~9.9 MB: a ~3 us bound, so launch latency and the
// byte loads are what the design has to keep small.
//
// Design.  The TPU kernels stream (512, 128) tiles through VMEM in grid
// order; here every thread owns elements at a grid stride, so any n is
// covered, a ragged tail included.  K1/K3 load and store float4 when every
// pointer is 16-byte aligned (torch allocations are), with a scalar tail.
// K5/K6 (run_wire_kernel, below with its own notes): each thread owns runs
// of 4 consecutive elements, g, the round bits and res in one 16-byte
// access each and the codes in wb 4-byte words, the digests summed from
// the words in registers with one modulo per run and folded in the same
// launch by the CTA that draws the last ticket of its stream's scratch.
// The kept wire_kernel
// reads and writes each element's wb code bytes (byte k of the
// little-endian word in column k of the (n, wb) wire, pack_exmy's
// layout).  With a digest, each thread accumulates the Fletcher sums
//   s1 = sum byte,   s2 = sum byte * ((pos mod 65521) + 1),  pos = i*wb + k
// of the received and the emitted wire in 64-bit registers; each block
// reduces its threads' sums and stores them mod 65521, and a one-block
// fold kernel sums the block partials and writes (s2 << 16) | s1 per
// wire.  The position weight makes any split of the sum exact, so the
// digest is deterministic and equals integrity.wire_digest.  Overflow:
// one byte term is < 256 * 65521 < 2^24 and a thread sums at most
// ceil(n / (blocks * threads)) * wb terms, so a 64-bit sum cannot wrap
// below 2^40 elements; block partials are < 65521 and at most 4096 of
// them are folded.
//
// The blocked arm needs each scale block's max before any element of the
// block can be cast, so it works over whole blocks, not a grid stride of
// elements.  Block 128 (the ring's default): one warp per block, each
// lane holding 4 elements (lane + 32 j, coalesced) in registers, the max
// by __shfl_xor; one pass.  Larger blocks (a multiple of 128 dividing
// 65536, the JAX fused rule): one CTA per block, which walks the block
// twice, the max first and then the cast, the second read (at most
// 256 KB of g and wb/4 of that of wire) served by the L2.  Per element it
// follows _make_wire_kernel step for step: unpack, unscale by the
// received sidecar shift (flushing what would land below 2^-126), add g,
// flush the sub-normal class, block max over finite magnitudes,
// k = exp(bmax) - 127 - emax clipped to [-128, 127], flush what scales
// below 2^-126, scale by 2^-k, cast (RTNE or SR), clamp the carry to
// ±max_finite, unscale with the same flush, and emit the canonical code
// (flushed and ±0 values as code 0, so the bytes equal pack_exmy_blocked
// of the partial); the sidecar byte k + 128 of block b goes after the
// n * wb code bytes.  The digests cover the whole buffer: a sidecar byte
// sits at position n * wb + b.  A short tail block's pad never enters
// the max (the loops stop at n).
//
// K7 spreads each row of the (W, B) gathered wire over several CTAs
// (blockIdx.y = row).  run_rows_kernel, the one the wrapper launches,
// reads a row in streaming 16-byte loads from its first 16-byte boundary
// (a scalar head and tail around them), sums them as K5/K6's runs are
// summed, and folds every row's sums in the same launch, writing int64
// digests.  The kept digest_rows_kernel stores each CTA's (s1, s2)
// partials mod 65521, and the fold kernel, with one CTA per row, sums
// them.  The byte weight is (pos mod 65521) + 1 of the position in the
// row, so any split is exact.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "exmy.cuh"

namespace {

constexpr int kThreads = 256;

// out = cast[_sr](x [+ y] [, r]): K1 <false, false>, K3 <true, false>,
// K2 <false, true>, K4 <true, true>.  Four instantiations, so a profile
// tells the kernels apart by name.
template <bool kAdd, bool kSR>
__device__ __forceinline__ float cast_one(float x, float y, uint32_t r,
                                          int eb, int mb) {
  const float v = kAdd ? __fadd_rn(x, y) : x;
  return kSR ? exmy::cast_sr(v, eb, mb, r) : exmy::cast(v, eb, mb);
}

template <bool kAdd, bool kSR>
__global__ void cast_kernel(const float* __restrict__ x,
                            const float* __restrict__ y,
                            const uint32_t* __restrict__ rbits,
                            float* __restrict__ out, int64_t n, int eb,
                            int mb, int vec) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  const int64_t tid = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* y4 = reinterpret_cast<const float4*>(y);
    const uint4* r4 = reinterpret_cast<const uint4*>(rbits);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 a = x4[i];
      const float4 b = kAdd ? y4[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      const uint4 r = kSR ? r4[i] : make_uint4(0u, 0u, 0u, 0u);
      float4 o;
      o.x = cast_one<kAdd, kSR>(a.x, b.x, r.x, eb, mb);
      o.y = cast_one<kAdd, kSR>(a.y, b.y, r.y, eb, mb);
      o.z = cast_one<kAdd, kSR>(a.z, b.z, r.z, eb, mb);
      o.w = cast_one<kAdd, kSR>(a.w, b.w, r.w, eb, mb);
      o4[i] = o;
    }
    done = n4 * 4;
  }
  for (int64_t i = done + tid; i < n; i += stride)
    out[i] = cast_one<kAdd, kSR>(x[i], kAdd ? y[i] : 0.f,
                                 kSR ? rbits[i] : 0u, eb, mb);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// each of a CTA's kS sums over its threads; the totals land in thread 0's
// s.  Every thread of the CTA must call it.
template <int kS>
__device__ __forceinline__ void cta_sum(unsigned long long (&s)[kS]) {
  __shared__ unsigned long long red[kS][kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    s[j] = warp_sum(s[j]);
    if (lane == 0) red[j][warp] = s[j];
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x / 32;
#pragma unroll
    for (int j = 0; j < kS; ++j)
      s[j] = warp_sum(lane < nw ? red[j][lane] : 0ull);
  }
}

// the kS digest sums of a CTA -> partials[slot * kS + j], mod 65521;
// every thread of the CTA must call it
template <int kS>
__device__ __forceinline__ void store_partials(unsigned long long (&s)[kS],
                                               unsigned long long* partials,
                                               size_t slot) {
  cta_sum(s);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < kS; ++j)
      partials[slot * kS + j] = s[j] % exmy::kDigestMod;
  }
}

// K6 (kFirst, no wire_in) and K5: res = cast[_sr]([unpack(wire_in) +] g
// [, rbits]), wire_out = pack(res); partials (4 per block: in s1, in s2,
// out s1, out s2, each mod 65521) when partials != nullptr
template <bool kFirst, bool kSR>
__global__ void wire_kernel(const uint8_t* __restrict__ wire_in,
                            const float* __restrict__ g,
                            const uint32_t* __restrict__ rbits,
                            float* __restrict__ res,
                            uint8_t* __restrict__ wire_out,
                            unsigned long long* __restrict__ partials,
                            int64_t n, int wb, int eb, int mb) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  unsigned long long s[4] = {0ull, 0ull, 0ull, 0ull};
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float v = g[i];
    uint32_t code_in = 0u;
    if (!kFirst) {
      const uint8_t* w = wire_in + i * wb;
      for (int k = 0; k < wb; ++k) code_in |= uint32_t(w[k]) << (8 * k);
      v = __fadd_rn(exmy::unpack_code(code_in, eb, mb), v);
    }
    const float q = kSR ? exmy::cast_sr(v, eb, mb, rbits[i])
                        : exmy::cast(v, eb, mb);
    res[i] = q;
    const uint32_t code = exmy::pack_code(q, eb, mb);
    uint8_t* o = wire_out + i * wb;
    for (int k = 0; k < wb; ++k) o[k] = uint8_t(code >> (8 * k));
    if (partials) {
      for (int k = 0; k < wb; ++k) {
        const unsigned long long pos =
            (unsigned long long)(i * wb + k) % exmy::kDigestMod + 1ull;
        const unsigned long long bo = (code >> (8 * k)) & 0xFFu;
        const unsigned long long bi = (code_in >> (8 * k)) & 0xFFu;
        s[0] += bi;
        s[1] += bi * pos;
        s[2] += bo;
        s[3] += bo * pos;
      }
    }
  }
  if (partials) store_partials(s, partials, blockIdx.x);
}

// the Fletcher terms of byte b at position pos into (s1, s2)
__device__ __forceinline__ void digest_byte(unsigned long long& s1,
                                            unsigned long long& s2,
                                            uint32_t b, long long pos) {
  s1 += b;
  s2 += (unsigned long long)b *
        ((unsigned long long)pos % exmy::kDigestMod + 1ull);
}

// one blocked hop's arithmetic; the shape (warp or CTA per scale block) is
// blocked_wire_kernel's
struct BlockedHop {
  const uint8_t* wire_in;     // codes then sidecar; null for hop 0
  const float* g;
  const uint32_t* rbits;      // null for RTNE
  float* res;
  uint8_t* wire_out;          // codes then sidecar
  long long n;
  int wb, eb, mb, emax;
  float mf;

  // s of element i: [unpack, unscale by k_in, +] g, then the flush;
  // code_in gets the received code word
  template <bool kFirst>
  __device__ __forceinline__ float sum(long long i, int k_in,
                                       uint32_t& code_in) const {
    float v = g[i];
    if (!kFirst) {
      code_in = 0u;
      const uint8_t* w = wire_in + i * wb;
      for (int k = 0; k < wb; ++k) code_in |= uint32_t(w[k]) << (8 * k);
      const float prev = exmy::unpack_code(code_in, eb, mb);
      const bool flush = exmy::is_finite(prev) && prev != 0.0f &&
                         exmy::frexp_exp(prev) + k_in <= -126;
      v = __fadd_rn(
          exmy::flush_low(flush ? 0.0f : exmy::scale_pow2(prev, k_in)), v);
    }
    return exmy::flush_low(v);
  }

  // the block shift from the block's max finite magnitude
  __device__ __forceinline__ int shift(float bmax) const {
    const int k = bmax > 0.0f ? exmy::exp_field(bmax) - 127 - emax : 0;
    return exmy::clampi(k, -128, 127);
  }

  // cast element i of a block with shift k, store res and its code bytes,
  // add both wires' bytes to the digest sums
  template <bool kFirst, bool kSR>
  __device__ __forceinline__ void emit(long long i, float s, int k,
                                       uint32_t code_in,
                                       unsigned long long* d) const {
    if (exmy::is_finite(s) && s != 0.0f && exmy::frexp_exp(s) - 1 - k <= -127)
      s = 0.0f;
    const float y = exmy::scale_pow2(s, -k);
    float q = kSR ? exmy::cast_sr(y, eb, mb, rbits[i]) : exmy::cast(y, eb, mb);
    if (exmy::is_finite(y) && fabsf(q) > mf) q = q > 0.0f ? mf : -mf;
    const bool out_flush = exmy::is_finite(q) && q != 0.0f &&
                           exmy::frexp_exp(q) + k <= -126;
    res[i] = exmy::flush_low(out_flush ? 0.0f : exmy::scale_pow2(q, k));
    const uint32_t code =
        exmy::pack_code(out_flush || q == 0.0f ? 0.0f : q, eb, mb);
    uint8_t* o = wire_out + i * wb;
    for (int k2 = 0; k2 < wb; ++k2) o[k2] = uint8_t(code >> (8 * k2));
    if (d) {
      for (int k2 = 0; k2 < wb; ++k2) {
        const long long pos = i * wb + k2;
        if (!kFirst) digest_byte(d[0], d[1], (code_in >> (8 * k2)) & 0xFFu, pos);
        digest_byte(d[2], d[3], (code >> (8 * k2)) & 0xFFu, pos);
      }
    }
  }

  // the sidecar byte of block b, and both sidecars' digest terms
  template <bool kFirst>
  __device__ __forceinline__ void sidecar(long long b, int k, int k_in,
                                          unsigned long long* d) const {
    wire_out[n * wb + b] = uint8_t(k + 128);
    if (d) {
      if (!kFirst) digest_byte(d[0], d[1], uint32_t(k_in + 128), n * wb + b);
      digest_byte(d[2], d[3], uint32_t(k + 128), n * wb + b);
    }
  }
};

// K6 (kFirst) / K5 over the block-scaled wire, RTNE or SR (kSR).  kWarp:
// one warp per 128-element block (bs == 128); else one CTA per block of
// bs elements.  digest partials as wire_kernel's when want_digest.
template <bool kFirst, bool kSR, bool kWarp>
__global__ void blocked_wire_kernel(BlockedHop h, int bs, long long nb,
                                    unsigned long long* __restrict__ partials) {
  unsigned long long s[4] = {0ull, 0ull, 0ull, 0ull};
  unsigned long long* d = partials ? s : nullptr;
  const int lane = threadIdx.x % 32;
  if (kWarp) {
    const long long warps = (long long)gridDim.x * (blockDim.x / 32);
    for (long long b = (long long)blockIdx.x * (blockDim.x / 32) +
                       threadIdx.x / 32;
         b < nb; b += warps) {
      const int k_in = kFirst ? 0 : int(h.wire_in[h.n * h.wb + b]) - 128;
      float v[4];
      uint32_t cin[4] = {0u, 0u, 0u, 0u};
      float m = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long i = b * 128 + lane + 32 * j;
        v[j] = 0.0f;
        if (i < h.n) {
          v[j] = h.sum<kFirst>(i, k_in, cin[j]);
          if (exmy::is_finite(v[j])) m = fmaxf(m, fabsf(v[j]));
        }
      }
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      const int k = h.shift(m);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long i = b * 128 + lane + 32 * j;
        if (i < h.n) h.emit<kFirst, kSR>(i, v[j], k, cin[j], d);
      }
      if (lane == 0) h.sidecar<kFirst>(b, k, k_in, d);
    }
  } else {
    __shared__ float red[kThreads / 32];
    const int warp = threadIdx.x / 32;
    for (long long b = blockIdx.x; b < nb; b += gridDim.x) {
      const long long lo = b * bs;
      const long long hi = lo + bs < h.n ? lo + bs : h.n;
      const int k_in = kFirst ? 0 : int(h.wire_in[h.n * h.wb + b]) - 128;
      float m = 0.0f;
      uint32_t cin = 0u;
      for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
        const float v = h.sum<kFirst>(i, k_in, cin);
        if (exmy::is_finite(v)) m = fmaxf(m, fabsf(v));
      }
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if (lane == 0) red[warp] = m;
      __syncthreads();
      m = 0.0f;
      for (int w = 0; w < int(blockDim.x / 32); ++w) m = fmaxf(m, red[w]);
      const int k = h.shift(m);
      for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
        const float v = h.sum<kFirst>(i, k_in, cin);
        h.emit<kFirst, kSR>(i, v, k, cin, d);
      }
      if (threadIdx.x == 0) h.sidecar<kFirst>(b, k, k_in, d);
      __syncthreads();   // red is rewritten by the next block
    }
  }
  if (partials) store_partials(s, partials, blockIdx.x);
}

// ---------------------------------------------------------------------------
// K5/K6 as the wrappers launch them: streaming kernels in 16-byte accesses
// whose digests cost one modulo per run and are folded in the same
// launch.  wire_kernel and blocked_wire_kernel above stay unchanged as the
// yardstick these are timed against (ops.quantize.core_wire_launcher); no
// path launches them.
//
// What bounds them.  At the ring chunk (988,944 elements, (5, 2)) a hop
// moves 9.9 MB, 3 us at 3.35 TB/s, but the cast, pack and unpack issue
// ~150 instructions an element (the SASS of the loop), ~4.5 us at one
// warp instruction per scheduler and clock: they are bound by issue, and
// by the parallelism that hides the cast's dependent chains.  So a run is
// 4 elements, not 16: at 16 a chunk gives 62k threads, 15 warps an SM,
// and the kernel ran no faster than the kept one (chip_smoke.py
// timed runs of 4, 8 and 16).  A digesting launch ends with a cross-CTA
// fold; its CTAs are 512 threads, so a quarter as many add their sums and
// draw tickets as at the 128 of a plain launch.

// threads per CTA: a digesting launch takes larger CTAs, so that fewer of
// them add to the digest sums and draw tickets
constexpr int kPlainThreads = 128;
constexpr int kDigestThreads = 512;
constexpr int kRun = 4;                 // elements a thread owns per run
constexpr int kMaxRunCtas = 4096;
// a digesting launch's scratch, in uint32 words: the two 64-bit digest
// sums, the ticket, and the fold-less timing form's two 64-bit sinks
constexpr int kSumsWord = 0;
constexpr int kTicketWord = 4;
constexpr int kSinkWord = 8;
constexpr int kScratchWords = 12;

// the streams of a launch, as bits of `vec`: those aligned at the start
// of every run (per-tensor arm) or 4-element group (blocked arm) to their
// accesses: 16 bytes for g, rbits and res; for the wires 16 bytes where a
// run's codes are 16 bytes, else 4.  A stream without its bit is read or
// written one element (byte) at a time.
enum : int { kVecG = 1, kVecR = 2, kVecIn = 4, kVecRes = 8, kVecOut = 16 };

// The single-launch digest's scratch: each CTA adds its sums to the two
// at kSumsWord, then draws a ticket from the word at kTicketWord; the CTA
// that draws the last one takes the sums, zeroing them, and resets the
// ticket to 0 for the next launch.  The caller gives each stream its own
// scratch, zeroed once (ops.quantize keeps one per device and stream):
// launches on one stream run in turn, so none adds to sums or draws from
// a ticket another has not yet reset, and launches on two streams never
// share them.

// the per-thread digest sums stay below kSumLimit = 65521 * 2^15 < 2^31:
// a term below 2^28 added to one cannot wrap 32 bits, and subtracting
// kSumLimit, a multiple of 65521, leaves its value mod 65521 as it is
constexpr uint32_t kSumLimit = 65521u * 32768u;

__device__ __forceinline__ void add_term(uint32_t& s, uint32_t t) {
  s += t;
  s = s >= kSumLimit ? s - kSumLimit : s;
}

// w advanced by step, both Fletcher weights in [1, 65521] and step below
// 65521: the weight of a position `step` (mod 65521) further on
__device__ __forceinline__ uint32_t advance_weight(uint32_t w,
                                                   uint32_t step) {
  w += step;
  return w > exmy::kDigestMod ? w - exmy::kDigestMod : w;
}

// (pos mod 65521) + 1: the Fletcher weight of the wire byte at pos
__device__ __forceinline__ uint32_t weight_at(unsigned long long pos) {
  return (pos >> 32 ? uint32_t(pos % exmy::kDigestMod)
                    : exmy::fletcher_mod65521(uint32_t(pos))) + 1u;
}

// The Fletcher terms of the 4 * kW bytes of w (little-endian words), the
// first at weight w0: byte j adds b_j to s1 and b_j * (w0 + j) to s2.
// Past the wrap the weight of byte j is w0 + j - 65521, which changes s2
// by a multiple of 65521 and so leaves the digest, s2 mod 65521, as it
// is.  __dp4a sums four bytes a step.  The terms stay below 2^28: a run or
// group holds at most 16 bytes (a1 <= 4080, a2 <= 30600) and w0 <= 65521.
template <int kW>
__device__ __forceinline__ void fold_words(const uint32_t (&w)[kW],
                                           uint32_t w0, uint32_t& s1,
                                           uint32_t& s2) {
  static_assert(kW <= 4, "the terms' bound assumes 16 bytes at most");
  uint32_t a1 = 0u, a2 = 0u;
#pragma unroll
  for (int j = 0; j < kW; ++j) {
    a1 = __dp4a(w[j], 0x01010101u, a1);
    a2 = __dp4a(w[j], 0x03020100u + 0x04040404u * uint32_t(j), a2);
  }
  add_term(s1, a1);
  add_term(s2, w0 * a1 + a2);
}

// the code word of element e of words holding kWb bytes per element
template <int kWb, int kW>
__device__ __forceinline__ uint32_t code_of(const uint32_t (&w)[kW], int e) {
  uint32_t c = 0u;
#pragma unroll
  for (int k = 0; k < kWb; ++k) {
    const int at = e * kWb + k;
    c |= ((w[at >> 2] >> (8 * (at & 3))) & 0xFFu) << (8 * k);
  }
  return c;
}

template <int kWb, int kW>
__device__ __forceinline__ void put_code(uint32_t (&w)[kW], int e,
                                         uint32_t code) {
#pragma unroll
  for (int k = 0; k < kWb; ++k) {
    const int at = e * kWb + k;
    w[at >> 2] |= ((code >> (8 * k)) & 0xFFu) << (8 * (at & 3));
  }
}

// kW words from p: streaming loads of 16 (k16) or 4 bytes when vec, else
// bytes
template <bool k16, int kW>
__device__ __forceinline__ void load_words(uint32_t (&w)[kW],
                                           const uint8_t* p, bool vec) {
  if (k16 && vec) {
#pragma unroll
    for (int j = 0; j < kW / 4; ++j) {
      const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p) + j);
      w[4 * j] = v.x, w[4 * j + 1] = v.y, w[4 * j + 2] = v.z;
      w[4 * j + 3] = v.w;
    }
  } else if (vec) {
#pragma unroll
    for (int j = 0; j < kW; ++j)
      w[j] = __ldcs(reinterpret_cast<const unsigned int*>(p) + j);
  } else {
#pragma unroll
    for (int j = 0; j < kW; ++j) w[j] = 0u;
#pragma unroll
    for (int k = 0; k < 4 * kW; ++k)
      w[k >> 2] |= uint32_t(p[k]) << (8 * (k & 3));
  }
}

template <bool k16, int kW>
__device__ __forceinline__ void store_words(uint8_t* p,
                                            const uint32_t (&w)[kW],
                                            bool vec) {
  if (k16 && vec) {
#pragma unroll
    for (int j = 0; j < kW / 4; ++j)
      reinterpret_cast<uint4*>(p)[j] =
          make_uint4(w[4 * j], w[4 * j + 1], w[4 * j + 2], w[4 * j + 3]);
  } else if (vec) {
#pragma unroll
    for (int j = 0; j < kW; ++j) reinterpret_cast<uint32_t*>(p)[j] = w[j];
  } else {
#pragma unroll
    for (int k = 0; k < 4 * kW; ++k)
      p[k] = uint8_t(w[k >> 2] >> (8 * (k & 3)));
  }
}

// kN 4-byte values from p: streaming 16-byte loads when vec, else scalars
template <int kN, class T>
__device__ __forceinline__ void load_vals(T (&v)[kN], const T* p, bool vec) {
  static_assert(sizeof(T) == 4 && kN % 4 == 0, "16-byte groups");
  if (vec) {
#pragma unroll
    for (int j = 0; j < kN / 4; ++j) {
      const uint4 x = __ldcs(reinterpret_cast<const uint4*>(p) + j);
      memcpy(&v[4 * j], &x, 16);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kN; ++j) v[j] = p[j];
  }
}

template <int kN>
__device__ __forceinline__ void store_floats(float* p, const float (&v)[kN],
                                             bool vec) {
  if (vec) {
#pragma unroll
    for (int j = 0; j < kN / 4; ++j)
      reinterpret_cast<float4*>(p)[j] =
          make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < kN; ++j) p[j] = v[j];
  }
}

// cast[_sr]([unpack(code_in) +] g): one element of the per-tensor hop
template <bool kFirst, bool kSR>
__device__ __forceinline__ float hop_value(float g, uint32_t code_in,
                                           uint32_t r, int eb, int mb) {
  const float v =
      kFirst ? g : __fadd_rn(exmy::unpack_code(code_in, eb, mb), g);
  return kSR ? exmy::cast_sr(v, eb, mb, r) : exmy::cast(v, eb, mb);
}

// each of kS sums over a CTA of kT threads, by the warps' reduce
// instruction; the totals land in thread 0's s (each input below 2^21, so
// no total wraps).  Every thread of the CTA must call it.
template <int kT, int kS>
__device__ __forceinline__ void cta_sum32(uint32_t (&s)[kS]) {
  __shared__ uint32_t red[kS][kT / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    s[j] = __reduce_add_sync(0xffffffffu, s[j]);
    if (lane == 0) red[j][warp] = s[j];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < kS; ++j)
      s[j] = __reduce_add_sync(0xffffffffu,
                               lane < kT / 32 ? red[j][lane] : 0u);
  }
}

// This CTA's 4 digest sums, folded in the launch: thread 0 adds them mod
// 65521 to the scratch's two 64-bit sums, (s2 << 32) | s1 of the received
// wire (K5 only) and of the emitted one, then draws a ticket with an
// acquire-release add, which orders those adds before it.  The thread that
// draws the last ticket takes both sums (zeroing them), writes digest[0]
// (received wire) and digest[1] (emitted wire) as (s2 << 16) | s1 and
// resets the ticket.  Integer adds, so any order of the CTAs gives the
// same bits; a half sums at most kMaxRunCtas values below 65521, under
// 2^28, so no carry crosses into the other.  With digest == NULL the
// adds go to the scratch's sink and no ticket is drawn: the form that
// times the fold's share.  Every thread of every CTA must call it.
template <int kT>
__device__ void fold_in_launch(const uint32_t (&s)[4],
                               uint32_t* __restrict__ scratch,
                               long long* __restrict__ digest) {
  uint32_t m[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) m[j] = exmy::fletcher_mod65521(s[j]);
  cta_sum32<kT, 4>(m);
  if (threadIdx.x != 0) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) m[j] = exmy::fletcher_mod65521(m[j]);
  unsigned long long* acc = reinterpret_cast<unsigned long long*>(
      scratch + (digest != nullptr ? kSumsWord : kSinkWord));
  if (m[0] | m[1]) atomicAdd(acc, (unsigned long long)m[1] << 32 | m[0]);
  atomicAdd(acc + 1, (unsigned long long)m[3] << 32 | m[2]);
  if (digest == nullptr) return;
  cuda::atomic_ref<unsigned int, cuda::thread_scope_device> ticket(
      scratch[kTicketWord]);
  if (ticket.fetch_add(1u, cuda::memory_order_acq_rel) != gridDim.x - 1)
    return;
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const unsigned long long t = atomicExch(acc + d, 0ull);
    digest[d] = (long long)(exmy::fletcher_mod65521(uint32_t(t >> 32)) << 16 |
                            exmy::fletcher_mod65521(uint32_t(t)));
  }
  ticket.store(0u, cuda::memory_order_relaxed);
}

struct RunHop {
  const uint8_t* wire_in;     // null for hop 0
  const float* g;
  const uint32_t* rbits;      // null for RTNE
  float* res;
  uint8_t* wire_out;
  uint32_t* scratch;          // kScratchWords; null: no digest
  long long* digest;          // (2,); null with scratch: no fold
  long long n, head, runs;    // elements; scalar ones before the runs; runs
  int eb, mb, vec;
  uint32_t wstep;             // the grid stride's bytes mod 65521
};

// K6 (kFirst) / K5 per tensor, RTNE or SR, kWb wire bytes per element, kT
// threads a CTA.  A thread owns runs of kRun consecutive elements at a
// grid stride: g and the round bits come in as streaming 16-byte loads,
// the received codes as kRun * kWb / 4 words (16-byte loads where that is
// a multiple of 4); res and the codes go out the same way.  Both wires are
// digested from the words in registers, one modulo per run.  The head
// before the first run (up to the alignment the streams share) and the
// ragged tail after the last take the scalar path in the first threads.
// A thread takes its first run's weight with one modulo and advances it
// by the stride's (h.wstep) with a compare and subtract.
template <bool kFirst, bool kSR, int kWb, int kT, bool kDigest>
__global__ void __launch_bounds__(kT) run_wire_kernel(RunHop h) {
  constexpr int kW = kRun * kWb / 4;    // words of a run's codes
  constexpr bool k16 = kW % 4 == 0;     // in 16-byte accesses
  uint32_t s[4] = {0u, 0u, 0u, 0u};
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  uint32_t w0 = kDigest
      ? weight_at((unsigned long long)(h.head + tid * kRun) * kWb) : 0u;
  for (long long r = tid; r < h.runs; r += stride) {
    const long long i0 = h.head + r * kRun;
    float v[kRun];
    uint32_t rb[kRun], win[kW], wout[kW];
    load_vals(v, h.g + i0, h.vec & kVecG);
    if (kSR) load_vals(rb, h.rbits + i0, h.vec & kVecR);
    if (!kFirst) load_words<k16>(win, h.wire_in + i0 * kWb, h.vec & kVecIn);
#pragma unroll
    for (int j = 0; j < kW; ++j) wout[j] = 0u;
#pragma unroll
    for (int e = 0; e < kRun; ++e) {
      v[e] = hop_value<kFirst, kSR>(v[e], kFirst ? 0u : code_of<kWb>(win, e),
                                    kSR ? rb[e] : 0u, h.eb, h.mb);
      put_code<kWb>(wout, e, exmy::pack_code(v[e], h.eb, h.mb));
    }
    store_floats(h.res + i0, v, h.vec & kVecRes);
    store_words<k16>(h.wire_out + i0 * kWb, wout, h.vec & kVecOut);
    if (kDigest) {
      if (!kFirst) fold_words(win, w0, s[0], s[1]);
      fold_words(wout, w0, s[2], s[3]);
      w0 = advance_weight(w0, h.wstep);
    }
  }
  const long long tail = h.head + h.runs * kRun;
  if (tid < h.head + (h.n - tail)) {
    const long long i = tid < h.head ? tid : tail + (tid - h.head);
    uint32_t cin = 0u;
    if (!kFirst)
      for (int k = 0; k < kWb; ++k)
        cin |= uint32_t(h.wire_in[i * kWb + k]) << (8 * k);
    const float q = hop_value<kFirst, kSR>(h.g[i], cin,
                                           kSR ? h.rbits[i] : 0u, h.eb, h.mb);
    h.res[i] = q;
    const uint32_t code = exmy::pack_code(q, h.eb, h.mb);
    for (int k = 0; k < kWb; ++k) {
      h.wire_out[i * kWb + k] = uint8_t(code >> (8 * k));
      if (kDigest) {
        const uint32_t w = weight_at((unsigned long long)(i * kWb + k));
        const uint32_t bi = (cin >> (8 * k)) & 0xFFu;
        const uint32_t bo = (code >> (8 * k)) & 0xFFu;
        add_term(s[0], bi), add_term(s[1], bi * w);
        add_term(s[2], bo), add_term(s[3], bo * w);
      }
    }
  }
  if (kDigest) fold_in_launch<kT>(s, h.scratch, h.digest);
}

// the blocked hop's operands; the shape (a warp or a CTA per scale block)
// is run_blocked_kernel's
struct BlockedRun {
  const uint8_t* wire_in;     // codes then sidecar; null for hop 0
  const float* g;
  const uint32_t* rbits;      // null for RTNE
  float* res;
  uint8_t* wire_out;          // codes then sidecar
  uint32_t* scratch;          // kScratchWords; null: no digest
  long long* digest;          // (2,); null with scratch: no fold
  long long n;
  int eb, mb, emax, vec;
  float mf;
  // block 128: the grid stride's code bytes and blocks mod 65521
  uint32_t wstep, sstep;
};

// s of the 4 elements i .. i + 3 (those below n): [unpack, unscale by
// k_in, +] g, then the flush, as BlockedHop::sum; win gets the received
// codes (zero past n).  full: all 4 are below n.
template <bool kFirst, int kWb>
__device__ __forceinline__ void group_sum(const BlockedRun& h, long long i,
                                          bool full, int k_in, float (&v)[4],
                                          uint32_t (&win)[kWb]) {
  if (full) {
    load_vals(v, h.g + i, h.vec & kVecG);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = i + j < h.n ? h.g[i + j] : 0.0f;
  }
  if (!kFirst) {
    if (full) {
      load_words<false>(win, h.wire_in + i * kWb, h.vec & kVecIn);
    } else {
#pragma unroll
      for (int j = 0; j < kWb; ++j) win[j] = 0u;
      for (int k = 0; k < 4 * kWb && i * kWb + k < h.n * kWb; ++k)
        win[k >> 2] |= uint32_t(h.wire_in[i * kWb + k]) << (8 * (k & 3));
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float x = v[j];
    if (!kFirst) {
      const float prev = exmy::unpack_code(code_of<kWb>(win, j), h.eb, h.mb);
      const bool flush = exmy::is_finite(prev) && prev != 0.0f &&
                         exmy::frexp_exp(prev) + k_in <= -126;
      x = __fadd_rn(
          exmy::flush_low(flush ? 0.0f : exmy::scale_pow2(prev, k_in)), x);
    }
    v[j] = exmy::flush_low(x);
  }
}

// the largest finite |s| of a group's elements below n
__device__ __forceinline__ float group_max(const float (&v)[4], long long i,
                                           long long n) {
  float m = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (i + j < n && exmy::is_finite(v[j])) m = fmaxf(m, fabsf(v[j]));
  return m;
}

// the block shift from the block's max finite magnitude
__device__ __forceinline__ int block_shift(float bmax, int emax) {
  const int k = bmax > 0.0f ? exmy::exp_field(bmax) - 127 - emax : 0;
  return exmy::clampi(k, -128, 127);
}

// cast the group's elements below n with shift k as BlockedHop::emit,
// store res and the codes, and add both wires' bytes (the received ones in
// win; the first at weight w0) to the digest sums s when digesting
template <bool kFirst, bool kSR, int kWb, bool kDigest>
__device__ __forceinline__ void group_emit(const BlockedRun& h, long long i,
                                           bool full, int k,
                                           const float (&v)[4],
                                           const uint32_t (&win)[kWb],
                                           uint32_t w0, uint32_t (&s)[4]) {
  uint32_t rb[4] = {0u, 0u, 0u, 0u};
  if (kSR) {
    if (full) {
      load_vals(rb, h.rbits + i, h.vec & kVecR);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) rb[j] = i + j < h.n ? h.rbits[i + j] : 0u;
    }
  }
  float out[4];
  uint32_t wout[kWb];
#pragma unroll
  for (int j = 0; j < kWb; ++j) wout[j] = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float x = v[j];
    if (exmy::is_finite(x) && x != 0.0f && exmy::frexp_exp(x) - 1 - k <= -127)
      x = 0.0f;
    const float y = exmy::scale_pow2(x, -k);
    float q = kSR ? exmy::cast_sr(y, h.eb, h.mb, rb[j])
                  : exmy::cast(y, h.eb, h.mb);
    if (exmy::is_finite(y) && fabsf(q) > h.mf) q = q > 0.0f ? h.mf : -h.mf;
    const bool out_flush = exmy::is_finite(q) && q != 0.0f &&
                           exmy::frexp_exp(q) + k <= -126;
    out[j] = exmy::flush_low(out_flush ? 0.0f : exmy::scale_pow2(q, k));
    if (i + j < h.n)
      put_code<kWb>(wout, j,
                    exmy::pack_code(out_flush || q == 0.0f ? 0.0f : q, h.eb,
                                    h.mb));
  }
  if (full) {
    store_floats(h.res + i, out, h.vec & kVecRes);
    store_words<false>(h.wire_out + i * kWb, wout, h.vec & kVecOut);
  } else {
    for (int j = 0; j < 4 && i + j < h.n; ++j) h.res[i + j] = out[j];
    for (int b = 0; b < 4 * kWb && i * kWb + b < h.n * kWb; ++b)
      h.wire_out[i * kWb + b] = uint8_t(wout[b >> 2] >> (8 * (b & 3)));
  }
  if (kDigest) {
    // the bytes past n are zero in win and wout: they add nothing
    if (!kFirst) fold_words(win, w0, s[0], s[1]);
    fold_words(wout, w0, s[2], s[3]);
  }
}

// the sidecar byte of block b (at weight w), and both sidecars' digest
// terms
template <bool kFirst, bool kDigest>
__device__ __forceinline__ void sidecar_of(const BlockedRun& h, int wb,
                                           long long b, int k, int k_in,
                                           uint32_t w, uint32_t (&s)[4]) {
  h.wire_out[h.n * wb + b] = uint8_t(k + 128);
  if (kDigest) {
    const uint32_t b_in = uint32_t(k_in + 128), b_out = uint32_t(k + 128);
    if (!kFirst) add_term(s[0], b_in), add_term(s[1], b_in * w);
    add_term(s[2], b_out), add_term(s[3], b_out * w);
  }
}

// K6 (kFirst) / K5 over the block-scaled wire, RTNE or SR.  kWarp (block
// 128): one warp per scale block, lane l owning the 4 consecutive
// elements 4l .. 4l + 3 (a 16-byte load of g, kWb words of codes), the
// block max by __shfl_xor; else one CTA per block of bs elements walking
// it twice in 4-element groups, the max first and then the cast.  Lane 0
// (thread 0) writes the block's sidecar byte at n * kWb + b.  The digest
// weights: at block 128 one modulo a thread, advanced by the stride's
// (h.wstep, h.sstep) with a compare and subtract; above it one a group.
// The digests are folded in the launch.
template <bool kFirst, bool kSR, bool kWarp, int kWb, int kT, bool kDigest>
__global__ void __launch_bounds__(kT)
    run_blocked_kernel(BlockedRun h, int bs, long long nb) {
  uint32_t s[4] = {0u, 0u, 0u, 0u};
  const int lane = threadIdx.x % 32;
  if (kWarp) {
    const long long warps = (long long)gridDim.x * (blockDim.x / 32);
    const long long b0 = (long long)blockIdx.x * (blockDim.x / 32) +
                         threadIdx.x / 32;
    uint32_t w0 = 0u, ws = 0u;
    if (kDigest) {
      w0 = weight_at((unsigned long long)(b0 * 128 + 4 * lane) * kWb);
      ws = weight_at((unsigned long long)(h.n * kWb + b0));
    }
    for (long long b = b0; b < nb; b += warps) {
      const int k_in = kFirst ? 0 : int(h.wire_in[h.n * kWb + b]) - 128;
      const long long i = b * 128 + 4 * lane;
      const bool full = i + 4 <= h.n;
      float v[4];
      uint32_t win[kWb];
      group_sum<kFirst, kWb>(h, i, full, k_in, v, win);
      float m = group_max(v, i, h.n);
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      const int k = block_shift(m, h.emax);
      if (i < h.n)
        group_emit<kFirst, kSR, kWb, kDigest>(h, i, full, k, v, win, w0, s);
      if (lane == 0) sidecar_of<kFirst, kDigest>(h, kWb, b, k, k_in, ws, s);
      if (kDigest) {
        w0 = advance_weight(w0, h.wstep);
        ws = advance_weight(ws, h.sstep);
      }
    }
  } else {
    __shared__ float red[kT / 32];
    const int warp = threadIdx.x / 32;
    for (long long b = blockIdx.x; b < nb; b += gridDim.x) {
      const long long lo = b * bs;
      const long long hi = lo + bs < h.n ? lo + bs : h.n;
      const int k_in = kFirst ? 0 : int(h.wire_in[h.n * kWb + b]) - 128;
      float m = 0.0f;
      for (long long i = lo + 4 * threadIdx.x; i < hi;
           i += 4 * blockDim.x) {
        float v[4];
        uint32_t win[kWb];
        group_sum<kFirst, kWb>(h, i, i + 4 <= h.n, k_in, v, win);
        m = fmaxf(m, group_max(v, i, h.n));
      }
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if (lane == 0) red[warp] = m;
      __syncthreads();
      m = 0.0f;
      for (int w = 0; w < int(blockDim.x / 32); ++w) m = fmaxf(m, red[w]);
      const int k = block_shift(m, h.emax);
      for (long long i = lo + 4 * threadIdx.x; i < hi;
           i += 4 * blockDim.x) {
        float v[4];
        uint32_t win[kWb];
        const bool full = i + 4 <= h.n;
        group_sum<kFirst, kWb>(h, i, full, k_in, v, win);
        group_emit<kFirst, kSR, kWb, kDigest>(
            h, i, full, k, v, win,
            kDigest ? weight_at((unsigned long long)i * kWb) : 0u, s);
      }
      if (threadIdx.x == 0)
        sidecar_of<kFirst, kDigest>(
            h, kWb, b, k, k_in,
            kDigest ? weight_at((unsigned long long)(h.n * kWb + b)) : 0u,
            s);
      __syncthreads();   // red is rewritten by the next block
    }
  }
  if (kDigest) fold_in_launch<kT>(s, h.scratch, h.digest);
}

// K7: per-(row, CTA) Fletcher partials of a (w, nbytes) u8 buffer, row
// blockIdx.y
__global__ void digest_rows_kernel(const uint8_t* __restrict__ rows,
                                   long long nbytes,
                                   unsigned long long* __restrict__ partials) {
  const uint8_t* r = rows + (long long)blockIdx.y * nbytes;
  unsigned long long s[2] = {0ull, 0ull};
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < nbytes; i += stride)
    digest_byte(s[0], s[1], r[i], i);
  store_partials(s, partials, (size_t)blockIdx.y * gridDim.x + blockIdx.x);
}

// ---------------------------------------------------------------------------
// K7 as the wrapper launches it: one streaming launch over every row, the
// digests folded in it as K5/K6's are.  digest_rows_kernel above
// and its fold_kernel<2> launch stay as the yardstick
// (ops.quantize.core_digest_launcher); no path launches them.
//
// What bounds it.  W * B bytes read once and W int64 digests written: at
// the verified ring's gathered wire (4 rows of 996,671 bytes) 1.19 us at
// 3.35 TB/s, so the launch itself and the fold's atomics are most of what
// a design can save.

// 256 threads a CTA and 2 loads in flight a thread (at the ring's
// gathered wire, 4 rows of 996,671 bytes: 488 CTAs).  Shapes from 128 to
// 1024 threads and 1 to 8 loads in flight timed close to each other on
// the card, this one among the fastest from HBM: the launch and the fold
// take most of the time, not the loads.
constexpr int kRowThreads = 256;
constexpr int kRowUnroll = 2;   // 16-byte loads a thread has in flight
// a row-digest launch's scratch, in uint32 words: the ticket and a pad
// word, then one 64-bit sum per row, (s2 << 32) | s1
constexpr int kRowSumsWord = 2;

// This CTA's row sums (s1, s2), folded in the launch: thread 0 adds them
// mod 65521 to the row's 64-bit sum in the scratch and draws a ticket with
// an acquire-release add, which orders that add before it; the CTA that
// draws the last ticket of the launch takes every row's sum (zeroing it),
// writes digest[r] = (s2 << 16) | s1 as int64 and resets the ticket.  A
// half sums at most kMaxRunCtas values below 65521, under 2^28, so no
// carry crosses into the other.  Every thread of every CTA must call it.
template <int kT>
__device__ void fold_rows(const uint32_t (&s)[2],
                          uint32_t* __restrict__ scratch,
                          long long* __restrict__ digest) {
  __shared__ int last;
  uint32_t m[2] = {exmy::fletcher_mod65521(s[0]),
                   exmy::fletcher_mod65521(s[1])};
  cta_sum32<kT, 2>(m);
  unsigned long long* sums =
      reinterpret_cast<unsigned long long*>(scratch + kRowSumsWord);
  const unsigned int ctas = gridDim.x * gridDim.y;
  if (threadIdx.x == 0) {
    m[0] = exmy::fletcher_mod65521(m[0]);
    m[1] = exmy::fletcher_mod65521(m[1]);
    if (m[0] | m[1])
      atomicAdd(sums + blockIdx.y, (unsigned long long)m[1] << 32 | m[0]);
    cuda::atomic_ref<unsigned int, cuda::thread_scope_device> ticket(
        scratch[0]);
    last = ticket.fetch_add(1u, cuda::memory_order_acq_rel) == ctas - 1;
  }
  __syncthreads();
  if (!last) return;
  for (unsigned int r = threadIdx.x; r < gridDim.y; r += kT) {
    const unsigned long long t = atomicExch(sums + r, 0ull);
    digest[r] = (long long)(exmy::fletcher_mod65521(uint32_t(t >> 32)) << 16 |
                            exmy::fletcher_mod65521(uint32_t(t)));
  }
  if (threadIdx.x == 0) {
    cuda::atomic_ref<unsigned int, cuda::thread_scope_device> ticket(
        scratch[0]);
    ticket.store(0u, cuda::memory_order_relaxed);
  }
}

// K7: the Fletcher digest of row blockIdx.y of a (w, nbytes) u8 buffer,
// spread over gridDim.x CTAs of kT threads.  A row starts wherever
// r * nbytes puts it: the bytes before its first 16-byte boundary (the
// head) and after its last (the tail) take the scalar path in the row's
// first threads; the rest comes in streaming 16-byte loads at a grid
// stride, kRowUnroll in flight a thread, each summed by fold_words (two
// __dp4a a word).  A thread takes its first load's weight with one modulo
// and advances it by the stride's (wstep, its bytes mod 65521) with a
// compare and subtract.
template <int kT>
__global__ void __launch_bounds__(kT)
    run_rows_kernel(const uint8_t* __restrict__ rows, long long nbytes,
                    uint32_t wstep, uint32_t* __restrict__ scratch,
                    long long* __restrict__ digest) {
  const uint8_t* row = rows + (long long)blockIdx.y * nbytes;
  long long head = (16 - (long long)(reinterpret_cast<uintptr_t>(row) & 15u))
                   & 15;
  head = head < nbytes ? head : nbytes;
  const long long chunks = (nbytes - head) / 16;
  const long long tail = head + chunks * 16;
  const uint4* body = reinterpret_cast<const uint4*>(row + head);
  const long long tid = (long long)blockIdx.x * kT + threadIdx.x;
  const long long stride = (long long)gridDim.x * kT;
  uint32_t s[2] = {0u, 0u};
  uint32_t w = weight_at((unsigned long long)(head + tid * 16));
  long long c = tid;
  for (; c + (kRowUnroll - 1) * stride < chunks; c += kRowUnroll * stride) {
    uint4 v[kRowUnroll];
#pragma unroll
    for (int j = 0; j < kRowUnroll; ++j) v[j] = __ldcs(body + c + j * stride);
#pragma unroll
    for (int j = 0; j < kRowUnroll; ++j) {
      const uint32_t words[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
      fold_words(words, w, s[0], s[1]);
      w = advance_weight(w, wstep);
    }
  }
  for (; c < chunks; c += stride) {
    const uint4 v = __ldcs(body + c);
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
    fold_words(words, w, s[0], s[1]);
    w = advance_weight(w, wstep);
  }
  if (tid < head + (nbytes - tail)) {
    const long long pos = tid < head ? tid : tail + (tid - head);
    const uint32_t b = row[pos];
    add_term(s[0], b);
    add_term(s[1], b * weight_at((unsigned long long)pos));
  }
  fold_rows<kT>(s, scratch, digest);
}

// out[i] = sr_bits_at((k0, k1), start + i), the offset wrapping mod 2^32
// as the JAX package's uint32 offsets do
__global__ void sr_bits_kernel(uint32_t* __restrict__ out, int64_t n,
                               uint32_t start, uint32_t k0, uint32_t k1) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = exmy::sr_bits_at(k0, k1, start + uint32_t(i));
}

// out[i] = x0 ^ x1 of TF((k0, k1), (0, i)): jax.random.bits(key, shape)
// at the flat index i (prng.random_bits), the bits quant_sgd's casts and
// the emulate-node pre-quantize draw
__global__ void flat_bits_kernel(uint32_t* __restrict__ out, int64_t n,
                                 uint32_t k0, uint32_t k1) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    uint32_t x0 = 0u, x1 = uint32_t(i);
    exmy::threefry2x32(k0, k1, x0, x1);
    out[i] = x0 ^ x1;
  }
}

// one CTA per row of `count` partials of kS sums each: the row's kS / 2
// digests (s2 << 16) | s1 at digest[row * kS / 2].  K5/K6: one row, kS 4
// (digest[0] the received wire, digest[1] the emitted one); K7: a row per
// gathered row, kS 2.
template <int kS>
__global__ void fold_kernel(const unsigned long long* __restrict__ partials,
                            int count, uint32_t* __restrict__ digest) {
  const unsigned long long* p = partials + size_t(blockIdx.x) * count * kS;
  unsigned long long s[kS] = {};
  for (int c = threadIdx.x; c < count; c += blockDim.x)
#pragma unroll
    for (int j = 0; j < kS; ++j) s[j] += p[size_t(c) * kS + j];
  cta_sum(s);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int d = 0; d < kS / 2; ++d)
      digest[blockIdx.x * (kS / 2) + d] =
          (uint32_t(s[2 * d + 1] % exmy::kDigestMod) << 16) |
          uint32_t(s[2 * d] % exmy::kDigestMod);
  }
}

int grid_for(int64_t work, int max_blocks) {
  const int64_t b = (work + kThreads - 1) / kThreads;
  return int(b < 1 ? 1 : (b > max_blocks ? max_blocks : b));
}

}  // namespace

template <bool kAdd, bool kSR>
void launch_cast(int blocks, cudaStream_t s, const float* x, const float* y,
                 const uint32_t* r, float* out, long long n, int eb, int mb,
                 int vec) {
  cast_kernel<kAdd, kSR><<<blocks, kThreads, 0, s>>>(x, y, r, out, n, eb,
                                                      mb, vec);
}

// K1 (y == NULL, rbits == NULL) / K3 (rbits == NULL) / K2 (y == NULL) /
// K4.  Returns the CUDA error code of the launch.
extern "C" int quantize_cast_launch(const void* x, const void* y,
                                    const void* rbits, void* out,
                                    long long n, int exp_bits, int man_bits,
                                    void* stream) {
  const uintptr_t mask = uintptr_t(x) | uintptr_t(y) | uintptr_t(rbits) |
                         uintptr_t(out);
  const int vec = (mask & 15u) == 0;
  const int blocks = grid_for(vec ? n / 4 + (n % 4) : n, 4096);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  const uint32_t* r = static_cast<const uint32_t*>(rbits);
  float* of = static_cast<float*>(out);
  if (y == nullptr && r == nullptr)
    launch_cast<false, false>(blocks, s, xf, yf, r, of, n, exp_bits,
                              man_bits, vec);
  else if (r == nullptr)
    launch_cast<true, false>(blocks, s, xf, yf, r, of, n, exp_bits,
                             man_bits, vec);
  else if (y == nullptr)
    launch_cast<false, true>(blocks, s, xf, yf, r, of, n, exp_bits,
                             man_bits, vec);
  else
    launch_cast<true, true>(blocks, s, xf, yf, r, of, n, exp_bits, man_bits,
                            vec);
  return int(cudaGetLastError());
}

// The SR bits of n elements at the offsets start + i.
extern "C" int quantize_sr_bits_launch(void* out, long long n,
                                       unsigned int start, unsigned int k0,
                                       unsigned int k1, void* stream) {
  sr_bits_kernel<<<grid_for(n, 4096), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), n, start, k0, k1);
  return int(cudaGetLastError());
}

// The flat-index bits of n elements at the indices 0 .. n - 1.
extern "C" int quantize_flat_bits_launch(void* out, long long n,
                                         unsigned int k0, unsigned int k1,
                                         void* stream) {
  flat_bits_kernel<<<grid_for(n, 4096), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), n, k0, k1);
  return int(cudaGetLastError());
}

// Blocks the wire kernel launches for n elements: the size (in groups of
// 4 uint64 words) of the `partials` scratch a digesting launch needs.
extern "C" int quantize_wire_blocks(long long n) {
  return grid_for(n, 4096);
}

template <bool kFirst, bool kSR>
void launch_wire(int blocks, cudaStream_t s, const uint8_t* in,
                 const float* g, const uint32_t* r, float* res, uint8_t* out,
                 unsigned long long* part, long long n, int wb, int eb,
                 int mb) {
  wire_kernel<kFirst, kSR><<<blocks, kThreads, 0, s>>>(in, g, r, res, out,
                                                        part, n, wb, eb, mb);
}

// K6 (wire_in == NULL) / K5, RTNE (rbits == NULL) or SR.  With partials
// != NULL also writes digest[0] (received wire; 0 for K6) and digest[1]
// (emitted wire).
extern "C" int quantize_wire_launch(const void* wire_in, const void* g,
                                    const void* rbits, void* res,
                                    void* wire_out, void* partials,
                                    void* digest, long long n, int wb,
                                    int exp_bits, int man_bits,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = grid_for(n, 4096);
  const uint8_t* in = static_cast<const uint8_t*>(wire_in);
  const float* gf = static_cast<const float*>(g);
  const uint32_t* r = static_cast<const uint32_t*>(rbits);
  float* rf = static_cast<float*>(res);
  uint8_t* out = static_cast<uint8_t*>(wire_out);
  unsigned long long* part = static_cast<unsigned long long*>(partials);
  if (wire_in == nullptr && r == nullptr)
    launch_wire<true, false>(blocks, s, in, gf, r, rf, out, part, n, wb,
                             exp_bits, man_bits);
  else if (wire_in == nullptr)
    launch_wire<true, true>(blocks, s, in, gf, r, rf, out, part, n, wb,
                            exp_bits, man_bits);
  else if (r == nullptr)
    launch_wire<false, false>(blocks, s, in, gf, r, rf, out, part, n, wb,
                              exp_bits, man_bits);
  else
    launch_wire<false, true>(blocks, s, in, gf, r, rf, out, part, n, wb,
                             exp_bits, man_bits);
  int err = int(cudaGetLastError());
  if (err != 0 || partials == nullptr) return err;
  fold_kernel<4><<<1, kThreads, 0, s>>>(
      static_cast<const unsigned long long*>(partials), blocks,
      static_cast<uint32_t*>(digest));
  return int(cudaGetLastError());
}

// CTAs the blocked wire kernel launches for n elements in blocks of bs:
// the size (in groups of 4 uint64 words) of its `partials` scratch.
extern "C" int quantize_blocked_blocks(long long n, int bs) {
  const long long nb = (n + bs - 1) / bs;
  const long long per_cta = bs == 128 ? kThreads / 32 : 1;
  const long long c = (nb + per_cta - 1) / per_cta;
  return int(c < 1 ? 1 : (c > 4096 ? 4096 : c));
}

template <bool kFirst, bool kSR>
void launch_blocked(int blocks, cudaStream_t s, const BlockedHop& h, int bs,
                    long long nb, unsigned long long* part) {
  if (bs == 128)
    blocked_wire_kernel<kFirst, kSR, true><<<blocks, kThreads, 0, s>>>(
        h, bs, nb, part);
  else
    blocked_wire_kernel<kFirst, kSR, false><<<blocks, kThreads, 0, s>>>(
        h, bs, nb, part);
}

// The blocked arm of K6 (wire_in == NULL) / K5, RTNE (rbits == NULL) or
// SR: wire_in and wire_out hold n * wb code bytes then ceil(n / bs)
// sidecar bytes.  bs is 128, or a multiple of 128 dividing 65536.  With
// partials != NULL also writes digest[0] (received wire; 0 for K6) and
// digest[1] (emitted wire), each over the whole buffer.
extern "C" int quantize_blocked_launch(const void* wire_in, const void* g,
                                       const void* rbits, void* res,
                                       void* wire_out, void* partials,
                                       void* digest, long long n, int bs,
                                       int wb, int exp_bits, int man_bits,
                                       void* stream) {
  if (bs < 128 || bs % 128 != 0 || 65536 % bs != 0 || n < 1)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BlockedHop h;
  h.wire_in = static_cast<const uint8_t*>(wire_in);
  h.g = static_cast<const float*>(g);
  h.rbits = static_cast<const uint32_t*>(rbits);
  h.res = static_cast<float*>(res);
  h.wire_out = static_cast<uint8_t*>(wire_out);
  h.n = n;
  h.wb = wb;
  h.eb = exp_bits;
  h.mb = man_bits;
  h.emax = ((1 << exp_bits) - 2) - ((1 << (exp_bits - 1)) - 1);
  const uint32_t man = man_bits == 0
      ? 0u : (0x7FFFFFu & ~((1u << (23 - man_bits)) - 1u));
  uint32_t mf_bits = (uint32_t(h.emax + 127) << 23) | man;
  memcpy(&h.mf, &mf_bits, sizeof(float));
  const long long nb = (n + bs - 1) / bs;
  const int blocks = quantize_blocked_blocks(n, bs);
  unsigned long long* part = static_cast<unsigned long long*>(partials);
  if (wire_in == nullptr && rbits == nullptr)
    launch_blocked<true, false>(blocks, s, h, bs, nb, part);
  else if (wire_in == nullptr)
    launch_blocked<true, true>(blocks, s, h, bs, nb, part);
  else if (rbits == nullptr)
    launch_blocked<false, false>(blocks, s, h, bs, nb, part);
  else
    launch_blocked<false, true>(blocks, s, h, bs, nb, part);
  int err = int(cudaGetLastError());
  if (err != 0 || partials == nullptr) return err;
  fold_kernel<4><<<1, kThreads, 0, s>>>(part, blocks,
                                        static_cast<uint32_t*>(digest));
  return int(cudaGetLastError());
}

namespace {

// CTAs of `kernel` the card keeps resident at `threads` threads each
template <class K>
int resident_ctas(K kernel, int threads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  return sms * per_sm > 0 ? sms * per_sm : 1;
}

// the grid of a launch that has `work` CTAs of work: no more than the card
// keeps resident (the kernels stride over the rest) nor kMaxRunCtas
int run_grid(long long work, int resident) {
  long long g = work < 1 ? 1 : work;
  if (g > resident) g = resident;
  return int(g > kMaxRunCtas ? kMaxRunCtas : g);
}

bool aligned(const void* p, long long offset, int to) {
  return (reinterpret_cast<uintptr_t>(p) + uintptr_t(offset)) % to == 0;
}

template <bool kFirst, bool kSR, int kWb, int kT, bool kDigest>
void launch_run_t(RunHop h, cudaStream_t s) {
  static const int resident =
      resident_ctas(run_wire_kernel<kFirst, kSR, kWb, kT, kDigest>, kT);
  const int grid = run_grid((h.runs + kT - 1) / kT, resident);
  h.wstep = uint32_t(1ull * grid * kT * kRun * kWb % exmy::kDigestMod);
  run_wire_kernel<kFirst, kSR, kWb, kT, kDigest><<<grid, kT, 0, s>>>(h);
}

template <bool kFirst, bool kSR, int kWb>
void launch_run(const RunHop& h, cudaStream_t s) {
  if (h.scratch)
    launch_run_t<kFirst, kSR, kWb, kDigestThreads, true>(h, s);
  else
    launch_run_t<kFirst, kSR, kWb, kPlainThreads, false>(h, s);
}

template <bool kFirst, bool kSR>
void launch_run_wb(const RunHop& h, int wb, cudaStream_t s) {
  if (wb == 1) launch_run<kFirst, kSR, 1>(h, s);
  else if (wb == 2) launch_run<kFirst, kSR, 2>(h, s);
  else if (wb == 3) launch_run<kFirst, kSR, 3>(h, s);
  else launch_run<kFirst, kSR, 4>(h, s);
}

template <bool kFirst, bool kSR, int kWb, int kT, bool kDigest>
void launch_blocked_t(BlockedRun h, int bs, long long nb, cudaStream_t s) {
  if (bs == 128) {
    static const int resident = resident_ctas(
        run_blocked_kernel<kFirst, kSR, true, kWb, kT, kDigest>, kT);
    constexpr int per = kT / 32;
    const int grid = run_grid((nb + per - 1) / per, resident);
    h.sstep = uint32_t(1ull * grid * per % exmy::kDigestMod);
    h.wstep = uint32_t(1ull * h.sstep * 128 * kWb % exmy::kDigestMod);
    run_blocked_kernel<kFirst, kSR, true, kWb, kT, kDigest>
        <<<grid, kT, 0, s>>>(h, bs, nb);
  } else {
    static const int resident = resident_ctas(
        run_blocked_kernel<kFirst, kSR, false, kWb, kT, kDigest>, kT);
    run_blocked_kernel<kFirst, kSR, false, kWb, kT, kDigest>
        <<<run_grid(nb, resident), kT, 0, s>>>(h, bs, nb);
  }
}

template <bool kFirst, bool kSR, int kWb>
void launch_blocked_run(const BlockedRun& h, int bs, long long nb,
                        cudaStream_t s) {
  if (h.scratch)
    launch_blocked_t<kFirst, kSR, kWb, kDigestThreads, true>(h, bs, nb, s);
  else
    launch_blocked_t<kFirst, kSR, kWb, kPlainThreads, false>(h, bs, nb, s);
}

template <bool kFirst, bool kSR>
void launch_blocked_wb(const BlockedRun& h, int bs, long long nb, int wb,
                       cudaStream_t s) {
  if (wb == 1) launch_blocked_run<kFirst, kSR, 1>(h, bs, nb, s);
  else if (wb == 2) launch_blocked_run<kFirst, kSR, 2>(h, bs, nb, s);
  else if (wb == 3) launch_blocked_run<kFirst, kSR, 3>(h, bs, nb, s);
  else launch_blocked_run<kFirst, kSR, 4>(h, bs, nb, s);
}

}  // namespace

// The uint32 words of the scratch a digesting quantize_run_launch or
// quantize_run_blocked_launch takes: zero before its stream's first
// launch, and left so by each launch that folds.
extern "C" int quantize_run_scratch_words(void) { return kScratchWords; }

// The path of quantize_run_launch's call on these pointers: the head
// (fewer than kRun scalar elements before the first run), chosen to align
// the most bytes of the five streams (g, rbits, wire_in, res, wire_out;
// null ones left out) to their accesses (16 bytes; the wires' 4-byte
// words where a run's codes are not 16 bytes), and in *vec the kVec*
// bits of the streams aligned there (1 g, 2 rbits, 4 wire_in, 8 res, 16
// wire_out).
extern "C" long long quantize_run_head(const void* wire_in, const void* g,
                                       const void* rbits, const void* res,
                                       const void* wire_out, long long n,
                                       int wb, int* vec) {
  const void* ptr[5] = {g, rbits, wire_in, res, wire_out};
  const int bytes[5] = {4, 4, wb, 4, wb};
  const int bits[5] = {kVecG, kVecR, kVecIn, kVecRes, kVecOut};
  const int wire_to = kRun * wb % 16 == 0 ? 16 : 4;   // the words' access
  const int to[5] = {16, 16, wire_to, 16, wire_to};
  int best = -1, head = 0;
  for (int at = 0; at < kRun; ++at) {
    int score = 0, v = 0;
    for (int j = 0; j < 5; ++j)
      if (ptr[j] != nullptr && aligned(ptr[j], 1LL * at * bytes[j], to[j]))
        score += bytes[j], v |= bits[j];
    if (score > best) best = score, *vec = v, head = at;
  }
  return head < n ? head : n;
}

// K6 (wire_in == NULL) / K5 per tensor, RTNE (rbits == NULL) or SR, wb in
// 1..4: the streaming kernel in one launch.  With scratch != NULL (the
// stream's quantize_run_scratch_words() words) it also writes digest[0]
// (received wire; 0 for K6) and digest[1] (emitted wire) as int64 holding
// the uint32 digests; with scratch and digest == NULL it computes the
// CTAs' partials but not the fold (a timing form, which writes no
// digest).  Launches that share a scratch must run in turn (one stream).
// The runs start at the head that aligns the most bytes of the five
// streams (quantize_run_head); a stream not aligned there is read or
// written element by element.
extern "C" int quantize_run_launch(const void* wire_in, const void* g,
                                   const void* rbits, void* res,
                                   void* wire_out, void* scratch,
                                   void* digest, long long n, int wb,
                                   int exp_bits, int man_bits,
                                   void* stream) {
  if (n < 1 || wb < 1 || wb > 4) return int(cudaErrorInvalidValue);
  RunHop h;
  h.wire_in = static_cast<const uint8_t*>(wire_in);
  h.g = static_cast<const float*>(g);
  h.rbits = static_cast<const uint32_t*>(rbits);
  h.res = static_cast<float*>(res);
  h.wire_out = static_cast<uint8_t*>(wire_out);
  h.scratch = static_cast<uint32_t*>(scratch);
  h.digest = static_cast<long long*>(digest);
  h.n = n;
  h.eb = exp_bits;
  h.mb = man_bits;
  h.head = quantize_run_head(wire_in, g, rbits, res, wire_out, n, wb, &h.vec);
  h.runs = (n - h.head) / kRun;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wire_in == nullptr && rbits == nullptr)
    launch_run_wb<true, false>(h, wb, s);
  else if (wire_in == nullptr)
    launch_run_wb<true, true>(h, wb, s);
  else if (rbits == nullptr)
    launch_run_wb<false, false>(h, wb, s);
  else
    launch_run_wb<false, true>(h, wb, s);
  return int(cudaGetLastError());
}

// The blocked arm of K6 / K5 as quantize_blocked_launch takes it (bs 128,
// or a multiple of 128 dividing 65536; wb in 1..4), on the streaming
// kernel: one launch, the digests folded in it, scratch and digest as
// quantize_run_launch takes them.
extern "C" int quantize_run_blocked_launch(const void* wire_in,
                                           const void* g, const void* rbits,
                                           void* res, void* wire_out,
                                           void* scratch, void* digest,
                                           long long n, int bs, int wb,
                                           int exp_bits, int man_bits,
                                           void* stream) {
  if (bs < 128 || bs % 128 != 0 || 65536 % bs != 0 || n < 1 || wb < 1 ||
      wb > 4)
    return int(cudaErrorInvalidValue);
  BlockedRun h;
  h.wire_in = static_cast<const uint8_t*>(wire_in);
  h.g = static_cast<const float*>(g);
  h.rbits = static_cast<const uint32_t*>(rbits);
  h.res = static_cast<float*>(res);
  h.wire_out = static_cast<uint8_t*>(wire_out);
  h.scratch = static_cast<uint32_t*>(scratch);
  h.digest = static_cast<long long*>(digest);
  h.n = n;
  h.eb = exp_bits;
  h.mb = man_bits;
  h.emax = ((1 << exp_bits) - 2) - ((1 << (exp_bits - 1)) - 1);
  const uint32_t man = man_bits == 0
      ? 0u : (0x7FFFFFu & ~((1u << (23 - man_bits)) - 1u));
  const uint32_t mf_bits = (uint32_t(h.emax + 127) << 23) | man;
  memcpy(&h.mf, &mf_bits, sizeof(float));
  h.vec = (aligned(g, 0, 16) ? kVecG : 0) |
          (rbits && aligned(rbits, 0, 16) ? kVecR : 0) |
          (wire_in && aligned(wire_in, 0, 4) ? kVecIn : 0) |
          (aligned(res, 0, 16) ? kVecRes : 0) |
          (aligned(wire_out, 0, 4) ? kVecOut : 0);
  const long long nb = (n + bs - 1) / bs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wire_in == nullptr && rbits == nullptr)
    launch_blocked_wb<true, false>(h, bs, nb, wb, s);
  else if (wire_in == nullptr)
    launch_blocked_wb<true, true>(h, bs, nb, wb, s);
  else if (rbits == nullptr)
    launch_blocked_wb<false, false>(h, bs, nb, wb, s);
  else
    launch_blocked_wb<false, true>(h, bs, nb, wb, s);
  return int(cudaGetLastError());
}

// The uint32 words of the scratch a digest_rows_run_launch over w rows
// takes: zero before its stream's first launch, and left so by each.
extern "C" long long digest_rows_scratch_words(int w) {
  return kRowSumsWord + 2LL * (w < 1 ? 1 : w);
}

// K7: digest[r] = wire_digest(rows[r]) as int64 for the w rows of nbytes
// bytes, in one launch of run_rows_kernel: enough CTAs a row that each
// thread has kRowUnroll 16-byte loads to make, no more than the card
// keeps resident over all rows, nor kMaxRunCtas.  scratch: the stream's
// digest_rows_scratch_words(w) words; launches that share one must run in
// turn (one stream).
extern "C" int digest_rows_run_launch(const void* rows, int w,
                                      long long nbytes, void* scratch,
                                      void* digest, void* stream) {
  if (w < 1 || w > 65535 || nbytes < 1) return int(cudaErrorInvalidValue);
  static const int resident =
      resident_ctas(run_rows_kernel<kRowThreads>, kRowThreads);
  constexpr long long per_cta = 16LL * kRowThreads * kRowUnroll;
  const int per_row = run_grid((nbytes + per_cta - 1) / per_cta,
                               resident / w > 0 ? resident / w : 1);
  const uint32_t wstep =
      uint32_t(16ull * kRowThreads * per_row % exmy::kDigestMod);
  run_rows_kernel<kRowThreads>
      <<<dim3(per_row, w), kRowThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(rows), nbytes, wstep,
          static_cast<uint32_t*>(scratch), static_cast<long long*>(digest));
  return int(cudaGetLastError());
}

// CTAs per row the kept K7 launches for (w, nbytes): its `partials`
// scratch holds w * ctas * 2 uint64 words.
extern "C" int digest_rows_ctas(int w, long long nbytes) {
  const long long per = (nbytes + kThreads * 16 - 1) / (kThreads * 16);
  long long cap = 4096 / (w < 1 ? 1 : w);
  if (cap < 1) cap = 1;
  return int(per < 1 ? 1 : (per > cap ? cap : per));
}

// The kept K7: digest[r] = wire_digest(rows[r]) (uint32) for the w rows of
// nbytes bytes, a partials launch and a fold launch.
extern "C" int digest_rows_launch(const void* rows, int w, long long nbytes,
                                  void* partials, void* digest,
                                  void* stream) {
  if (w < 1 || w > 65535 || nbytes < 1) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ctas = digest_rows_ctas(w, nbytes);
  unsigned long long* part = static_cast<unsigned long long*>(partials);
  digest_rows_kernel<<<dim3(ctas, w), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(rows), nbytes, part);
  int err = int(cudaGetLastError());
  if (err != 0) return err;
  fold_kernel<2><<<w, kThreads, 0, s>>>(part, ctas,
                                        static_cast<uint32_t*>(digest));
  return int(cudaGetLastError());
}

extern "C" const char* quantize_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
