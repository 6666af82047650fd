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
// K1-K4 share one templated on kAdd and kSR); their blocked arm is a
// second kernel, blocked_wire_kernel, templated the same way.  The
// per-element arithmetic is exmy.cuh, bitwise the plain version's.  Like the TPU kernels, the SR
// arms take their uint32 round bits as an operand.  Those bits come from
// sr_bits_kernel, the port of what the JAX package computes in XLA
// (numerics.sr_bits_at: two threefry2x32 per element); it is bound by
// the integer instructions it issues per element (about two on the
// 64-lane ALU pipe per threefry round), not by its 4 written bytes.
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
// The wire kernel reads and writes each element's wb code bytes (byte k of
// the little-endian word in column k of the (n, wb) wire, pack_exmy's
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
// (blockIdx.y = row); each CTA stores its row's (s1, s2) partials mod
// 65521, and the same fold kernel, with one CTA per row, sums them.  The byte
// weight is (pos mod 65521) + 1 of the position in the row, so any split
// is exact, and 64-bit sums cannot wrap.

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

// out[i] = sr_bits_at((k0, k1), start + i), the offset wrapping mod 2^32
// as the JAX package's uint32 offsets do
__global__ void sr_bits_kernel(uint32_t* __restrict__ out, int64_t n,
                               uint32_t start, uint32_t k0, uint32_t k1) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = exmy::sr_bits_at(k0, k1, start + uint32_t(i));
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

// CTAs per row K7 launches for (w, nbytes): its `partials` scratch holds
// w * ctas * 2 uint64 words.
extern "C" int digest_rows_ctas(int w, long long nbytes) {
  const long long per = (nbytes + kThreads * 16 - 1) / (kThreads * 16);
  long long cap = 4096 / (w < 1 ? 1 : w);
  if (cap < 1) cap = 1;
  return int(per < 1 ? 1 : (per > cap ? cap : per));
}

// K7: digest[r] = wire_digest(rows[r]) for the w rows of nbytes bytes.
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
